"""Device-busy ms a train step: the union of kernel intervals over the
profiled steps, over their count (``torch.profiler``)."""


def read(record):
    p = record.get("profile")
    if not p or p["kind"] != "train" or not p["kernels"]:
        return None
    return 1e3 * p["busy_s"] / p["units"]
