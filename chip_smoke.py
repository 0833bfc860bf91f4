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
  5. the main path: Trainer.run(2) at the CHAOS point at full width
     (two-modal FuseUNet, base width 32, 256 px, batch 8, 4 TTA views, bf16
     autocast), cut in depth to 4 train cases x 16 slices (8 steps an
     epoch) and one 16-slice test case, the clean case labeled: each epoch
     runs the train steps, the fused test pass, re-inference of the train
     cases, largest-CC and case Dice, the best-checkpoint gate and a label
     refresh of 1 case a net. Every history value must be finite, 2
     refresh decisions an epoch logged, the rewritten tempmasks must read
     back as the labels and the device labels equal the host's, each best
     .pkl must load with torch.load, and the kernel must have launched
     exactly 3 times per train step and never in case evaluation. After
     the run, the separate test pass (_test_epoch) and the per-batch
     test-case predictions must agree with the last row's fused test pass
     within 5e-3;
  6. a small slice (32 px, base width 4, f32, TF32 off, 4 train cases) on
     the card, once with the data on the device (the fused test pass) and
     once with host batches (device_cache "off": the separate test pass and
     per-batch predictions), each against the same slice on the CPU from
     the same weights and view parameters, 2 epochs of run_epoch with
     refresh: identical refresh decisions, each with a margin (the CPU's
     dice gap at the worst-k boundary above the largest card-CPU case-dice
     difference), working labels within Dice 0.995, history metrics within
     1e-3 (relative above 1, absolute below).
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
import shutil
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


def fresh_dir(path: str) -> str:
    """An empty directory: tempmasks or exports of an earlier run in the
    same checkout would be read back as this run's labels."""
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def check_refresh(trainer) -> None:
    """The refreshed working labels: each rewritten case's tempmask PNGs
    read back (the port's own reader) equal to the host labels, and the
    device copy equals the host labels after the sync."""
    import numpy as np

    pipe, task = trainer.train_pipe, trainer.task
    checked = 0
    for _, net, _, rewritten in trainer.refresh_log:
        for case in rewritten:
            for i in pipe.case_indices(case):
                disk = task.read_tempmask(pipe.specs[i], net)
                if disk is None or not np.array_equal(disk, pipe.labels.get(net)[i]):
                    fail(f"tempmask of {case} slice {i} net {net} does not read back as the label")
                checked += 1
    for net in (1, 2):
        dev = pipe._device_labels[f"target{net}"].cpu().numpy()
        if not np.array_equal(dev, pipe.labels.get(net)):
            fail(f"device labels of net {net} differ from the host's after the sync")
    print(f"refresh: {len(trainer.refresh_log)} decisions {trainer.refresh_log}; "
          f"{checked} rewritten slices read back equal; device labels equal the host's", flush=True)


def check_best_exports(trainer) -> None:
    """Each net's best-epoch .pkl loads with torch.load and holds the
    net's state-dict keys."""
    import torch

    from aide_tpu_torch.engine import checkpoint as ckpt

    cfg = trainer.cfg
    for n, net in enumerate(trainer.state.nets, start=1):
        path = ckpt.best_net_path(cfg.checkpoint_dir, cfg.experiment_name, n)
        obj = torch.load(path, map_location="cpu")
        if set(obj["net"]) != set(net.state_dict()):
            fail(f"{path} does not hold net {n}'s state dict")
        print(f"best export net{n}: epoch {obj['epoch']}, traincase_dice {obj['traincase_dice']:.6f}, "
              f"{os.path.getsize(path)} bytes", flush=True)


def check_unfused_test(trainer, row) -> None:
    """The test pass without the fusion, on the same weights as the last
    epoch's: the separate test pass (_test_epoch, the eval step over the
    pipe's batches) against the row's test metrics, and the per-batch
    predictions (predict_step on batch_at) against its test-case dice.
    Under bf16 autocast the separate pass's batch of 16 against the fused
    pass's 32 (half of it padding) may take other convolution algorithms,
    hence a bar of 5e-3, relative above 1 and absolute below."""
    import numpy as np

    from aide_tpu_torch.evaluation.case_eval import start_case_evaluation

    test_m = trainer._test_epoch()
    testcase = start_case_evaluation(
        trainer._predict_batch, trainer.state, trainer.test_pipe, trainer.test_cases,
        trainer.cfg.data.eval_batch_size, target_net=None,
        keep_largest_cc=trainer.cfg.eval.keep_largest_cc,
    )()
    got = {f"test_{k}": v for k, v in test_m.items()}
    got.update({f"testcase_dice{n + 1}": float(np.mean([r.dice for r in testcase[n]]))
                for n in testcase})
    diff = {k: abs(v - row[k]) / max(abs(row[k]), 1.0) for k, v in got.items()}
    print("unfused test pass and per-batch test-case predictions vs the fused epoch row: "
          + json.dumps({k: [got[k], row[k]] for k in got}), flush=True)
    if len(got) != 6 or not all(math.isfinite(v) for v in got.values()) or max(diff.values()) > 5e-3:
        fail(f"the unfused test pass disagrees with the fused one: {diff}")


def run_slice(cuda_warp, scratch):
    """Phase 5: the main path at the CHAOS point, cut in depth only:
    Trainer.run(2) with case evaluation, the checkpoint gate and refresh."""
    import torch

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = chaos_config()
    cfg.checkpoint_dir = fresh_dir(os.path.join(scratch, "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(scratch, "hist"))
    cfg.data.tempmask_folder = "tempmasks"
    task = SyntheticTask(
        root=fresh_dir(os.path.join(scratch, "chaos")), tempmask_folder="tempmasks",
        two_modal=True, num_cases=4, slices_per_case=16, size=256,
        noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
        test_case_offset=100, seed=7,
    )
    # release the blocks phases 3-4 left cached before the trainer allocates:
    # the allocator counts a large block it does not split in full, so the
    # peak would depend on what the earlier phases allocated
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, task)
    trainer.label_cases = set(task.clean_case_ids())  # as bench.py does
    setup_s = time.perf_counter() - t0
    if trainer.device.type != "cuda":
        fail(f"Trainer chose {trainer.device}, not the card")

    step_ms = []
    train_launches = []
    inner_step, inner_epoch = trainer.train_step, trainer._train_epoch

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_step(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def counted_epoch(*args):
        before = cuda_warp.launches
        out = inner_epoch(*args)
        train_launches.append(cuda_warp.launches - before)
        return out

    trainer.train_step = timed_step
    trainer._train_epoch = counted_epoch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_warp.reset_launches()
    rows = trainer.run(2)
    torch.cuda.synchronize()
    launches = cuda_warp.launches
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step, trainer._train_epoch = inner_step, inner_epoch

    n_steps = len(step_ms)
    spe = trainer.train_pipe.steps_per_epoch(cfg.data.batch_size)
    for row in rows:
        print(f"epoch {row['epoch']}: " + json.dumps(row), flush=True)
        print(f"epoch {row['epoch']} phases (s): " + json.dumps(
            {k: row[k] for k in ("time_train", "time_test", "time_cases", "time_cases_fetch",
                                 "time_cases_host", "time_ckpt", "time_refresh", "time")}),
            flush=True)
    values = [v for row in rows for v in row.values()]
    if len(rows) != 2 or n_steps != 2 * spe or not all(math.isfinite(v) for v in values):
        fail(f"run(2) gave non-finite or missing history ({len(rows)} rows, {n_steps} steps)")
    if len(trainer.refresh_log) != 2 * 2:
        fail(f"expected 2 refresh decisions an epoch, got {trainer.refresh_log}")
    check_refresh(trainer)
    check_best_exports(trainer)
    outside = launches - sum(train_launches)
    if launches != 3 * n_steps or outside != 0:
        fail(f"warp kernel launched {launches} times over {n_steps} steps "
             f"({outside} outside the train steps), expected {3 * n_steps} and 0")
    check_unfused_test(trainer, rows[-1])
    steady = statistics.median(step_ms[spe:])
    print(f"slice: {n_steps} steps, setup {setup_s:.2f} s, first step {step_ms[0]:.1f} ms, "
          f"median step after the first epoch {steady:.3f} ms, "
          f"max_memory_allocated {peak} bytes, warp launches {launches} "
          f"({launches // n_steps} per step, {outside} in case evaluation)", flush=True)
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


def small_config():
    """Phase 6's slice: 32 px, base width 4, f32, both epochs refreshing."""
    from aide_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.base_width = 4
    cfg.model.compute_dtype = "float32"
    cfg.data.task = "synthetic"
    cfg.data.img_size = 32
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 3
    cfg.data.num_tta_views = 2
    cfg.coteach.warmup_epochs = 3  # both epochs refresh
    # AMSGrad's first steps move each parameter by about lr along its
    # gradient's sign, which rounding decides for near-zero gradients; at
    # lr 1e-4 that alone moves the thresholded dice sums by up to ~5e-3
    # between two runs, at 1e-6 by ~1e-6 (tests/test_torch_trainer.py)
    cfg.optim.lr = 1e-6
    return cfg


def small_run(cfg, device, cache, weights, scratch):
    """Two epochs of run_epoch on phase 6's slice from ``weights`` (None:
    the seed's own initialisation). Returns the rows, the refresh log, the
    working labels, each refresh's case dice {(epoch, net): {case: dice}},
    the worst-k count and the initial weights."""
    import numpy as np
    import torch

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    root = fresh_dir(os.path.join(scratch, f"small_{device}_{cache}"))
    cfg.checkpoint_dir = os.path.join(root, "ckpt")
    cfg.history_dir = os.path.join(root, "hist")
    cfg.data.device_cache = cache
    # 4 train cases, so that int(0.25 * 4) = 1 case a net is refreshed
    task = SyntheticTask(
        root=root, tempmask_folder="tempmasks", two_modal=True, num_cases=4,
        slices_per_case=4, size=32, noisy_fraction=0.5, clean_cases=1,
        num_test_cases=1, test_case_offset=100, seed=8,
    )
    tr = Trainer(cfg, task, device=device)
    tr.label_cases = set(task.clean_case_ids())
    # count the unfused branch's calls: the separate test pass and the
    # per-batch predictions
    calls = {"_test_epoch": 0, "predict_step": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    tr._test_epoch = counted("_test_epoch", tr._test_epoch)
    tr.predict_step = counted("predict_step", tr.predict_step)
    case_dice = {}
    inner_refresh = tr._refresh_labels

    def refresh(epoch, traincase):
        for n in traincase:
            case_dice[epoch, n] = {r.case_id: r.dice for r in traincase[n]}
        inner_refresh(epoch, traincase)

    tr._refresh_labels = refresh
    if weights is None:
        weights = [{k: v.detach().cpu().clone() for k, v in n.state_dict().items()}
                   for n in tr.state.nets]
    for net, sd in zip(tr.state.nets, weights):
        net.load_state_dict(sd)

    def view_params(epoch, step, b):
        g = np.random.default_rng(1000 * epoch + step)
        views = (g.uniform(-60, 60, (2, b)).astype(np.float32),
                 (g.random((2, b)) < 0.5).astype(np.float32))
        return tuple(torch.from_numpy(x).to(tr.device) for x in views)

    tr.view_params = view_params
    rows = [tr.run_epoch(e) for e in range(2)]
    took = all(calls.values()) if cache == "off" else not any(calls.values())
    if not took:
        fail(f"device_cache {cache!r} on {device} did not take its branch: {calls}")
    print(f"small slice on {device}, device_cache {cache!r}: unfused-branch calls {calls}",
          flush=True)
    k = int(cfg.coteach.update_percent * len(tr.train_cases))
    labels = [tr.train_pipe.labels.get(n) for n in (1, 2)]
    return rows, tr.refresh_log, labels, case_dice, k, weights


def boundary_gaps(case_dice, k):
    """{(epoch, net): the dice gap between the k-th and (k+1)-th worst case}."""
    gaps = {}
    for key, d in case_dice.items():
        ranked = sorted(d.values())
        gaps[key] = ranked[k] - ranked[k - 1]
    return gaps


def small_slice_vs_cpu(scratch):
    """Phase 6: two epochs of run_epoch at 32 px, with refresh, f32, from
    the same weights and view parameters: on the card with the data on the
    device (the fused test pass, whole-set prediction) and with host
    batches (device_cache "off": the separate test pass, per-batch
    prediction), each against the CPU.

    The refresh comparison means something only where the CPU run's worst-k
    boundary is not a tie (a net that predicts no foreground scores several
    cases 0). So the CPU runs first, from initialisation seeds 0, 1, ...,
    until every refresh has a gap at that boundary; which seed gives one
    depends on the torch build. Then each card run must repeat the CPU's
    decisions, and each gap must exceed the largest card-CPU case-dice
    difference."""
    from aide_tpu_torch.evaluation.case_eval import dice3d_np

    cfg = small_config()
    for seed in range(10):
        cfg.seed = seed
        cpu_rows, cpu_log, cpu_labels, cpu_dice, k, weights = small_run(
            cfg, "cpu", "auto", None, scratch)
        gaps = boundary_gaps(cpu_dice, k)
        print(f"small slice, CPU, initialisation seed {seed}: worst-{k} boundary gaps "
              + json.dumps(sorted(gaps.items())), flush=True)
        if len(gaps) == len(cpu_log) and min(gaps.values()) > 0.0:
            break
    else:
        fail("no initialisation seed in 0-9 gives the CPU run a refresh without a tie")
    for cache in ("auto", "off"):
        gpu_rows, gpu_log, gpu_labels, gpu_dice, _, _ = small_run(
            cfg, "cuda", cache, weights, scratch)
        name = f"small slice, card (device_cache {cache!r}) vs CPU"
        if gpu_log != cpu_log:
            fail(f"{name}: refresh decisions differ: card {gpu_log}, CPU {cpu_log}")
        agreement = [dice3d_np(g, c) for g, c in zip(gpu_labels, cpu_labels)]
        # thresholded dice sums can sit near 0, so the bar is relative above
        # 1 and absolute below it
        worst = 0.0
        for g, c in zip(gpu_rows, cpu_rows):
            for key, v in c.items():
                if not key.startswith("time"):
                    worst = max(worst, abs(g[key] - v) / max(abs(v), 1.0))
        margins = [(gaps[key], max(abs(gpu_dice[key][c] - d) for c, d in cpu_dice[key].items()))
                   for key in sorted(cpu_dice)]
        print(f"{name}: refresh margins (CPU gap at the worst-{k} boundary, largest card-CPU "
              f"case-dice difference): " + json.dumps(margins), flush=True)
        print(f"{name}: refresh decisions identical {gpu_log}; working-label agreement "
              f"{agreement[0]:.6f}/{agreement[1]:.6f}; worst metric difference {worst:.3e} "
              f"(relative above 1, absolute below)", flush=True)
        if not all(gap > diff for gap, diff in margins):
            fail(f"{name}: a refresh decision has no margin: {margins}")
        if min(agreement) < 0.995:
            fail(f"{name}: working labels agree only to Dice {agreement}")
        if worst > 1e-3:
            fail(f"{name}: metrics disagree: {gpu_rows} vs {cpu_rows}")


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
