"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (it fails without them). Inputs and weights come from
``--seed``. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number that decides
``correct`` beside its limit, which also close standard error. Work files
go to a directory under ``TMPDIR`` that the run removes; kernel and build
caches stay in ``build/`` in the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict  # noqa: E402

from benchmark import manifest as mf  # noqa: E402

# top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "aide_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: str) -> None:
    """Kernel and extension caches at fixed paths inside the checkout."""
    cache = os.path.join(root, "build", "bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")


def bytes_written() -> Dict[str, int]:
    """This process's writes so far: ``wchar``, the bytes handed to write
    calls, and ``write_bytes``, those that reached a block device."""
    out = {}
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def run_cell(manifest: Dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, root: str = mf.HERE) -> Dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    from benchmark import common, peaks

    w = mf.workload(manifest, cell)
    config = mf.config(w["config"], root)
    traffic = mf.traffic(w["traffic"], root)
    limits = mf.limits(cell, root)
    info = (peaks.device_info(device) if device.type == "cuda"
            else {"name": device.type, "power_limit_w": None})
    log(f"{cell}: seed {seed}, {seconds} s, trace {int(trace)}; {info['name']}, power limit "
        f"{info['power_limit_w']} W")
    workdir = tempfile.mkdtemp(prefix=f"bench_{cell}_")
    try:
        ctx = common.Context(cell=cell, config=config, traffic=traffic, seed=seed,
                             seconds=seconds, trace=trace, device=device, workdir=workdir,
                             t_process=t_process)
        out = mf.driver(traffic["driver"], root).run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded the JAX package or JAX: {bad}")

    record = dict(out["record"], device=info)
    metrics = {}
    if trace:
        for m in mf.cell_metrics(manifest, "per_layer", cell):
            value = mf.reader(m["name"], root)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in mf.cell_metrics(manifest, "end_to_end", cell):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in out["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": info["name"],
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    profile = out.get("profile")
    if trace and profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["wall_s"]
        result["breakdown"] = profile["breakdown"]
    result["checks"] = checks
    log(f"bytes written by this process: {bytes_written()}")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    set_cache_dirs(mf.ROOT)
    manifest = mf.load()
    chips = mf.workload(manifest, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed % (1 << 63), args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_PROCESS)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
