"""The TTA warp kernel's share of its roofline in %: the least time of the
profiled steps' launches (bytes from the cell's shapes,
``kernels.coteach_warp_launches``, over the card's HBM bandwidth) over the
kernel's device time in the trace. None where the trace's launches are
not the steps' (a step with no warp, or a count that differs)."""

from benchmark import kernels, peaks, trace


def read(record):
    p = record.get("profile")
    bw = peaks.HBM_BYTES_PER_S.get(record["device"]["name"])
    if not p or p["kind"] != "train" or not bw or record["traffic"]["variant"] != "proposed":
        return None
    c = record["config"]
    shapes = kernels.coteach_warp_launches(c["batch_size"], c["num_tta_views"], c["img_size"],
                                           c["two_modal"], c["model"]["num_classes"])
    us, count = trace.kernel_us(p["kernels"], "warp_rotate_flip")
    if count != len(shapes) * p["units"] or us <= 0:
        return None
    return 100.0 * kernels.warp_bound_s(shapes, bw) * p["units"] / (us / 1e6)
