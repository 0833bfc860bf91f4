#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aide_tpu_torch) on one NVIDIA GPU.

Phases:
  1. header: torch/CUDA versions, the card's name and power limit;
  2. build the TTA warp kernel from aide_tpu_torch/csrc with nvcc;
  3. hold the kernel against its plain PyTorch version on the card
     (33/64/100/256/512 px, C in {2, 3}, both directions, degrees over ±135
     plus the ±45, ±135 and ±180 boundaries, both flips, (B, C) fills, and
     single images): max abs <= 1e-5;
  4. time the kernel at the main path's two shapes with a cold L2 (a 64 MB
     buffer written between runs, outside the events) and a warm one, and
     the plain version (CUDA events, medians) beside the bytes-over-bandwidth
     bound; with --baseline FILE.cu (repeatable), other builds of the
     kernel's entry point are timed the same way, in turns with this one;
  5. the main path: Trainer at the CHAOS point at full width (two-modal
     FuseUNet, base width 32, 256 px, batch 8, 4 TTA views, bf16 autocast),
     cut in depth to 2 train cases x 16 slices (4 steps an epoch) and one
     16-slice test case: 2 train epochs at rate 0.5, then the test pass.
     Every loss and dice must be finite and the kernel must have launched
     exactly 3 times per train step;
  6. a small slice (32 px, base width 4, f32, TF32 off) on the card against
     the same slice on the CPU from the same weights and view parameters:
     epoch metrics within 1e-3 (relative above 1, absolute below).
Then the {"kernels": [...]} JSON line and, last, {"ok": true, "device":
{...}}.

Run from the repository root:
  python3 chip_smoke.py [--profile] [--baseline FILE.cu]
(--profile adds, after phase 5, a torch.profiler breakdown of a few more
steps; --baseline times another version of csrc/warp_rotate_flip.cu, for
instance an earlier commit's, beside this one in phase 4; it may be given
more than once).
It exits non-zero, printing no result, without a CUDA device, or when any
check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's clock
# degrees where the residual angle, the rot90 or the shear coefficients
# change regime
BOUNDARY_DEGREES = (44.9, 45.0, 45.1, -44.9, -45.0, -45.1, 135.0, -135.0, 180.0, -180.0)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_cuda(fn, runs: int = 30, warmup: int = 5, flush=None) -> float:
    """Median ms of ``fn`` over ``runs`` calls, each between CUDA events;
    ``flush`` runs before each call, outside the events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        # keep the device busy while the host enqueues the events and fn, so
        # that the events time the device's work and not the host's launch
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def warp_inputs(degrees, hflip, s, c, seed, device):
    import torch

    n = len(degrees)
    g = torch.Generator(device="cpu").manual_seed(seed)
    images = torch.randn((n, s, s, c), generator=g).to(device)
    fill = torch.randn((n, c), generator=g).to(device)
    degrees = torch.as_tensor(degrees, dtype=torch.float32)
    hflip = torch.as_tensor(hflip, dtype=torch.float32)
    return images, degrees.to(device), hflip.to(device), fill


def check_kernel(cuda_warp, device):
    """Phase 3: kernel against the plain version on the card."""
    import torch

    degs = [float(d) for d in torch.linspace(-135.0, 135.0, 12)] + list(BOUNDARY_DEGREES)
    cases = [(degs * 2, [0.0] * len(degs) + [1.0] * len(degs), s, c)
             for s in (33, 64, 100, 256, 512) for c in (2, 3)]
    cases += [([45.0], [1.0], 256, 3), ([-60.0], [0.0], 33, 2), ([180.0], [1.0], 100, 2)]
    worst = 0.0
    for degrees, hflip, s, c in cases:
        for inverse in (False, True):
            images, degrees_t, hflip_t, fill = warp_inputs(degrees, hflip, s, c, seed=s + c,
                                                           device=device)
            n = len(degrees)
            table = cuda_warp.coef_table(degrees_t, hflip_t, inverse)
            fills = cuda_warp.fill_table(fill, n, c, device)
            got = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill, inverse=inverse)
            ref = cuda_warp.warp_plain(images, table, fills, inverse)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            finite = bool(torch.isfinite(got).all())
            print(f"kernel vs plain  N={n:2d} {s:3d}px C={c} "
                  f"{'inverse' if inverse else 'forward'}: max abs {err:.3e}", flush=True)
            if not finite or err > 1e-5:
                fail(f"kernel disagrees with its plain version at N={n} {s}px C={c} "
                     f"inverse={inverse}: max abs {err}")
            worst = max(worst, err)
    return worst


def raw_launch(lib, images, table, fills, inverse, out):
    """One launch of a built library's warp_rotate_flip_f32, uncounted."""
    import torch

    n, s, _, c = images.shape
    err = lib.warp_rotate_flip_f32(images.data_ptr(), out.data_ptr(), table.data_ptr(),
                                   fills.data_ptr(), n, s, c, int(inverse),
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"baseline kernel launch failed: CUDA error {err}")


def time_kernel(cuda_warp, device, baselines=()):
    """Phase 4: kernel and plain-version times at the main path's shapes,
    cold (L2 flushed before each run) and warm. Baseline libraries, given
    as (name, ctypes library) pairs, are timed in turns with the kernel:
    b1, b2, ..., kernel, kernel, ..., b2, b1."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def flush():
        scratch.fill_(1.0)

    rows = []
    for shape, inverse in (((32, 256, 256, 3), False), ((64, 256, 256, 2), True)):
        n, s, _, c = shape
        degrees = [60.0 * (2.0 * i / (n - 1) - 1.0) for i in range(n)]  # the main path's ±60
        images, degrees, hflip, fill = warp_inputs(degrees, [i % 2 for i in range(n)], s, c,
                                                   seed=7, device=device)
        table = cuda_warp.coef_table(degrees, hflip, inverse)
        fills = cuda_warp.fill_table(fill, n, c, device)
        got = cuda_warp.launch(images, table, fills, inverse)
        ref = cuda_warp.warp_plain(images, table, fills, inverse)
        err = float((got - ref).abs().max())
        if err > 1e-5:
            fail(f"kernel disagrees at the main path shape {shape}: {err}")
        versions = {"kernel": lambda: cuda_warp.launch(images, table, fills, inverse)}
        out = torch.empty_like(images)
        for name, lib in baselines:
            versions[name] = (lambda lib=lib: raw_launch(lib, images, table, fills, inverse, out))
            versions[name]()
            torch.cuda.synchronize()
            base_err = float((out - ref).abs().max())
            if base_err > 1e-5:
                fail(f"baseline {name} disagrees at the main path shape {shape}: {base_err}")
        names = [name for name, _ in baselines]
        order = names + ["kernel", "kernel"] + names[::-1]
        cold = {k: [] for k in versions}
        warm = {k: [] for k in versions}
        for k in order:
            cold[k].append(time_cuda(versions[k], flush=flush))
            warm[k].append(time_cuda(versions[k]))
        k_ms = statistics.mean(cold["kernel"])
        k_warm = statistics.mean(warm["kernel"])
        w_ms = time_cuda(lambda: cuda_warp.warp_rotate_flip(images, degrees, hflip, fill, inverse),
                         flush=flush)
        p_ms = time_cuda(lambda: cuda_warp.warp_plain(images, table, fills, inverse), runs=20)
        nbytes = cuda_warp.bytes_moved(shape)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        label = "inverse" if inverse else "forward"
        print(f"timing {label} {shape}: kernel cold {k_ms:.4f} ms, warm {k_warm:.4f} ms, "
              f"wrapper cold {w_ms:.4f} ms, plain {p_ms:.4f} ms, bytes {nbytes}, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_ms / k_ms:.1%} of the bound cold, "
              f"{bound_ms / k_warm:.1%} warm)", flush=True)
        row = dict(shape=shape, inverse=inverse, ms=k_ms, ms_warm=k_warm, wrapper_ms=w_ms,
                   plain_ms=p_ms, bytes=nbytes, bound_ms=bound_ms, max_abs_err=err)
        if baselines:
            row["baselines"] = {
                name: {"ms": statistics.mean(cold[name]), "ms_warm": statistics.mean(warm[name])}
                for name in names}
            row["turns"] = {k: {"cold": cold[k], "warm": warm[k]} for k in versions}
            for name, t in row["baselines"].items():
                print(f"timing {label} {shape}: baseline {name} cold {t['ms']:.4f} ms, "
                      f"warm {t['ms_warm']:.4f} ms ({bound_ms / t['ms']:.1%} of the bound cold)",
                      flush=True)
            print(f"timing {label} turns: " + json.dumps(row["turns"]), flush=True)
        rows.append(row)
    del scratch
    return rows


def chaos_config():
    from aide_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.name = "fuseunet"
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.packed = True  # a TPU layout knob; a no-op in the port
    cfg.data.task = "synthetic"
    cfg.data.img_size = 256
    cfg.data.batch_size = 8
    cfg.data.eval_batch_size = 32
    cfg.data.num_tta_views = 4
    cfg.data.rotation_degree = 60.0
    cfg.coteach.warmup_epochs = 20
    cfg.num_epochs = 100
    return cfg


def run_slice(cuda_warp, scratch):
    """Phase 5: the main path at the CHAOS point, cut in depth only."""
    import torch

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = chaos_config()
    task = SyntheticTask(
        root=os.path.join(scratch, "chaos"), tempmask_folder="tempmasks",
        two_modal=True, num_cases=2, slices_per_case=16, size=256,
        noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
        test_case_offset=100, seed=7,
    )
    # release the blocks phases 3-4 left cached before the trainer allocates:
    # the allocator counts a large block it does not split in full, so the
    # peak would depend on what the earlier phases allocated
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, task)
    setup_s = time.perf_counter() - t0
    if trainer.device.type != "cuda":
        fail(f"Trainer chose {trainer.device}, not the card")

    step_ms = []
    inner = trainer.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_warp.reset_launches()
    epochs = [trainer._train_epoch(e, 0.5) for e in range(2)]
    test = trainer._test_epoch()
    torch.cuda.synchronize()
    launches = cuda_warp.launches
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step = inner

    n_steps = len(step_ms)
    spe = trainer.train_pipe.steps_per_epoch(cfg.data.batch_size)
    for e, m in enumerate(epochs):
        print(f"epoch {e}: " + json.dumps(m), flush=True)
    print("test: " + json.dumps(test), flush=True)
    values = [v for m in epochs + [test] for v in m.values()]
    if n_steps != 2 * spe or not values or not all(math.isfinite(v) for v in values):
        fail(f"slice produced non-finite or missing metrics ({n_steps} steps)")
    if launches != 3 * n_steps:
        fail(f"warp kernel launched {launches} times over {n_steps} steps, expected {3 * n_steps}")
    steady = statistics.median(step_ms[spe:])
    print(f"slice: {n_steps} steps, setup {setup_s:.2f} s, first step {step_ms[0]:.1f} ms, "
          f"median step after the first epoch {steady:.3f} ms, "
          f"max_memory_allocated {peak} bytes, warp launches {launches} "
          f"({launches // n_steps} per step)", flush=True)
    return trainer, launches, steady, peak


# kernel-name fragments that group the profile (first match wins)
KERNEL_KINDS = (
    ("warp_kernel", ("warp_rotate_flip",)),
    ("conv", ("xmma", "implicit_gemm", "conv", "cudnn", "wgrad", "dgrad", "gemm", "cutlass")),
    ("batch_norm", ("batch_norm",)),
    ("upsample", ("upsample",)),
    ("max_pool", ("max_pool",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("copy_cast_cat", ("copy", "CatArray", "Memcpy", "Memset")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def profile_steps(trainer, steps: int = 3) -> None:
    """With --profile: device time by kernel over a few more co-teaching
    steps at the CHAOS point, and the device's busy share of the host wall
    time around them (torch.profiler, CUPTI)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b = trainer.cfg.data.batch_size
    batch = next(trainer.train_pipe.batches(b, rng=np.random.default_rng(0)))
    degrees, hflip = trainer.view_params(0, 0, b)
    trainer.train_step(trainer.state, batch, degrees, hflip, 0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(trainer.state, batch, degrees, hflip, 0.5)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, z in spans:
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    by_name, by_kind = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        kind = next((k for k, keys in KERNEL_KINDS if any(w in e.name for w in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print("profile: " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us > 0 else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "kinds_ms_per_step": {k: t / steps / 1e3
                              for k, t in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n[:90], t / steps / 1e3] for n, t in top],
    }), flush=True)


def small_slice_vs_cpu(scratch):
    """Phase 6: the slice at 32 px on the card against the CPU, f32."""
    import numpy as np
    import torch

    from aide_tpu_torch.core.config import TrainConfig
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = TrainConfig()
    cfg.model.base_width = 4
    cfg.model.compute_dtype = "float32"
    cfg.data.task = "synthetic"
    cfg.data.img_size = 32
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 3
    cfg.data.num_tta_views = 2
    # AMSGrad's first steps move each parameter by about lr along its
    # gradient's sign, which rounding decides for near-zero gradients; at
    # lr 1e-4 that alone moves the thresholded dice sums by up to ~5e-3
    # between two runs, at 1e-6 by ~1e-6 (tests/test_torch_trainer.py)
    cfg.optim.lr = 1e-6
    views = {}

    def view_params(device):
        def draw(epoch, step, b):
            if (epoch, step) not in views:
                g = np.random.default_rng(1000 * epoch + step)
                views[(epoch, step)] = (
                    g.uniform(-60, 60, (2, b)).astype(np.float32),
                    (g.random((2, b)) < 0.5).astype(np.float32),
                )
            return tuple(torch.from_numpy(x).to(device) for x in views[(epoch, step)])
        return draw

    results, weights = [], None
    for device in ("cuda", "cpu"):
        task = SyntheticTask(
            root=os.path.join(scratch, f"small_{device}"), two_modal=True,
            num_cases=2, slices_per_case=4, size=32, noisy_fraction=0.5,
            clean_cases=1, seed=3,
        )
        tr = Trainer(cfg, task, device=device)
        if weights is None:
            weights = [{k: v.detach().cpu().clone() for k, v in n.state_dict().items()}
                       for n in tr.state.nets]
        for net, sd in zip(tr.state.nets, weights):
            net.load_state_dict(sd)
        tr.view_params = view_params(tr.device)
        results.append([tr._train_epoch(0, 0.5), tr._train_epoch(1, 0.5), tr._test_epoch()])
    # thresholded dice sums can sit near 0, so the bar is relative above 1
    # and absolute below it
    worst = 0.0
    for gpu_m, cpu_m in zip(*results):
        for k in cpu_m:
            worst = max(worst, abs(gpu_m[k] - cpu_m[k]) / max(abs(cpu_m[k]), 1.0))
    print(f"small slice, card vs CPU: worst metric difference {worst:.3e} "
          f"(relative above 1, absolute below)", flush=True)
    if worst > 1e-3:
        fail(f"small slice on the card disagrees with the CPU: {results}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="a torch.profiler breakdown of a few more steps after phase 5")
    parser.add_argument("--baseline", metavar="FILE.cu", action="append", default=[],
                        help="another version of csrc/warp_rotate_flip.cu to time in phase 4 "
                             "(repeatable)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from aide_tpu_torch.ops import cuda_warp

    scratch = os.path.join(root, "build", "chip_smoke")
    os.makedirs(scratch, exist_ok=True)
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"device {name}, count {torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)  # name, power limit: as nvidia-smi gives them

    t0 = time.perf_counter()
    cuda_warp.build(verbose=True)
    baselines = [(path, cuda_warp.load(cuda_warp.build(verbose=True, source=os.path.abspath(path))))
                 for path in args.baseline]
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = check_kernel(cuda_warp, device)
    rows = time_kernel(cuda_warp, device, baselines)
    torch.backends.cudnn.allow_tf32 = True

    trainer, launches, step_ms, peak = run_slice(cuda_warp, scratch)
    if args.profile:
        profile_steps(trainer)
    del trainer

    torch.backends.cudnn.allow_tf32 = False
    small_slice_vs_cpu(scratch)

    fwd, inv = rows
    kernels = [{
        "name": "warp_rotate_flip",
        "route": "cuda",
        "source": "aide_tpu_torch/csrc/warp_rotate_flip.cu",
        "replaces": "aide_tpu/ops/pallas_warp.py:77",
        "launches": launches,
        "max_abs_err": max(worst, fwd["max_abs_err"], inv["max_abs_err"]),
        # one main-path step: two forward launches and one inverse launch,
        # each timed with a cold L2 (per_launch also has the warm times)
        "ms": 2 * fwd["ms"] + inv["ms"],
        "plain_ms": 2 * fwd["plain_ms"] + inv["plain_ms"],
        "bound_ms": 2 * fwd["bound_ms"] + inv["bound_ms"],
        "bound_us": (2 * fwd["bound_ms"] + inv["bound_ms"]) * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "per_launch": rows,
        "step_ms": step_ms,
        "max_memory_allocated": peak,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
