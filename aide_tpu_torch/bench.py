"""Benchmark: the full CHAOS co-teaching epoch of the port on one card.

The counterpart of the JAX package's ``bench.py``. The reference reports
~420 s/epoch for the flagship CHAOS proposed config (dual FuseUNet
co-teaching, 984 training slices, batch 4, 4 TTA views, 256x256), and that
includes everything its epoch loop does: train steps, test-batch eval,
per-case 3D test eval, per-case train re-inference for both nets,
checkpointing and the label refresh.

This benchmark runs the port's complete ``Trainer.run_epoch`` at the same
operating point (30 train cases x 33 slices = 990, 10 test cases x 33
slices, 256x256 two-modal, 4 TTA views, batch 8) on a size-matched
synthetic dataset and reports the wall-clock seconds of one epoch after a
warm-up epoch (which carries cuDNN's autotuning and the first allocations).
The other points (``TASK_POINTS``) are the kidney, breast and prostate
trainers' models and resolutions. Secondary fields: the step-extrapolated
epoch from ``BARE_STEPS`` bare train steps, and the step's throughput in
TFLOP/s and as a share (MFU) of the card's dense bf16 tensor-core peak.

Model FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode``
over one extra real train step, outside the timed steps: the convolutions
and matmuls the network runs, forward and backward, from their shapes. The
port runs the plain network (no packed layout), so the executed FLOPs are
the model FLOPs and ``mfu_basis`` is always "model"; the JAX package's CPU
subprocess probe of the unpacked twin has no counterpart. The TTA warp
kernel is not an aten op and counts 0 FLOP: it is a bandwidth-bound gather
(a few dozen flops an output pixel), a negligible share of the count.

Prints ONE JSON line on stdout (the logs go to stderr):
  {"metric": "chaos_coteach_epoch_seconds", "value": <s>, "unit": "s/epoch",
   "vs_baseline": <420 / value>, ...}
with the card's name and power limit beside the numbers.

Usage: python -m aide_tpu_torch.bench [--task chaos|kidney|breast|prostate]
       [--batch N] [--supervised] [--eval-volume] [--steps-only]
       [--profile DIR] [--device cpu]
It runs on the first CUDA card and raises without one, unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import graphs
from aide_tpu_torch.engine.trainer import Trainer, resolve_device
from aide_tpu_torch.evaluation.case_eval import evaluate_cases, infer_cases
from aide_tpu_torch.ops import cc

EPOCH_SLICES = 984      # CHAOS proposed train set (the reference's README.md:45)
BASELINE_EPOCH_S = 420.0
# the reference's supervised comparison config at the same operating point
# (single fuseunet, no TTA/coteach) runs ~300 s/epoch (README.md:45)
SUPERVISED_BASELINE_S = 300.0
# the reference quotes "several seconds" per 3D volume for its eval scripts
# (README.md:46, bs=1 slice loop + CPU scipy CC); 3.0 s is the charitable
# low end of "several", used as the nominal vs_baseline
EVAL_VOLUME_BASELINE_S = 3.0
# Dense bf16 tensor-core peak in TFLOP/s by torch.cuda.get_device_name():
# NVIDIA's H100 data sheet gives 1,979 TFLOPS for the SXM5 part "with
# sparsity", so the dense rate is half of it. MFU is measured against this;
# a card not listed gets no peak and no MFU.
PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.5}
# the timed bare train steps of the step-extrapolated metric
BARE_STEPS = 16
# the train steps that --profile traces, from the middle of the timed epoch
PROFILE_STEPS = 3

# The operating points: kidney trainers run a single-modal UNet at 512 px
# (trainkidney_proposed_mask1.py), breast at 384 px
# (trainbreast_dataset3_proposed_272cases25labeled.py), prostate at 256 px
# (trainprostate_proposed_isbi3ttransferisbidx.py:42). The reference
# publishes no epoch times for them, so vs_baseline is reported against the
# CHAOS proposed 420 s for scale only.
TASK_POINTS = {
    "chaos": dict(model="fuseunet", img=256, two_modal=True,
                  cases=30, slices=33, test_cases=10),
    "kidney": dict(model="unet", img=512, two_modal=False,
                   cases=24, slices=10, test_cases=6),
    "breast": dict(model="unet", img=384, two_modal=False,
                   cases=60, slices=5, test_cases=10),
    "prostate": dict(model="unet", img=256, two_modal=False,
                     cases=30, slices=15, test_cases=10),
}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def work_dir(name: str) -> str:
    """The bench's directory ``name`` under the temporary directory, apart
    from the JAX bench's, so that neither clears the other's files."""
    return os.path.join(tempfile.gettempdir(), f"aide_torch_bench_{name}")


def make_config(batch: int, variant: str = "proposed", task: str = "chaos",
                eval_batch: int = 0) -> TrainConfig:
    pt = TASK_POINTS[task]
    cfg = TrainConfig()
    cfg.model = ModelConfig(name=pt["model"], compute_dtype="bfloat16")
    # the JAX package's TPU layout knobs at its bench's defaults; the port
    # accepts them and runs the plain network, which computes the same
    cfg.model.packed = True
    cfg.model.packed_block_barrier = True
    cfg.data.task = "synthetic"
    cfg.data.variant = variant
    cfg.data.img_size = pt["img"]
    cfg.data.batch_size = batch
    cfg.data.eval_batch_size = eval_batch or max(batch, 32)
    cfg.data.num_tta_views = 4
    cfg.data.rotation_degree = 60.0
    cfg.coteach.warmup_epochs = 20
    cfg.num_epochs = 100
    cfg.checkpoint_dir = work_dir("ckpt")
    cfg.history_dir = work_dir("hist")
    cfg.data.tempmask_folder = "tempmasks"
    # the decoded arrays survive across bench runs
    cfg.data.decode_cache_dir = work_dir("decode_cache")
    return cfg


def build_trainer(cfg: TrainConfig, task_name: str = "chaos", device=None) -> Trainer:
    """The trainer of a point on its synthetic dataset: the CHAOS point has
    30 train cases x 33 slices = 990 (984 in the reference) and 10 test
    cases of as many slices (the reference's 300 slices in 10 cases), one
    labeled (clean) case and noisy working labels on half of the others;
    the other points have their cases and slices from ``TASK_POINTS``."""
    pt = TASK_POINTS[task_name]
    task = SyntheticTask(
        root=work_dir("data"),
        tempmask_folder=cfg.data.tempmask_folder,
        two_modal=pt["two_modal"],
        num_cases=pt["cases"],
        slices_per_case=pt["slices"],
        size=cfg.data.img_size,
        noisy_fraction=0.5,
        clean_cases=1,
        num_test_cases=pt["test_cases"],
        test_case_offset=100,
        seed=7,
    )
    trainer = Trainer(cfg, task=task, device=device)
    trainer.label_cases = set(task.clean_case_ids())
    return trainer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_bare_steps(trainer: Trainer, cfg: TrainConfig, iters: int = BARE_STEPS):
    """The trainer's own train step on the first batch of the train set,
    with the view parameters drawn as ``run_epoch`` draws them: warm steps
    until the step replays its CUDA graph on a card (``engine.graphs``:
    the eager steps and the capture), then ``iters`` timed steps on the
    host clock after a synchronise.
    Returns (mean step seconds, model FLOPs of one step, (the warp
    kernel's host-called launches, the steps that replayed the graph,
    whose warp kernels launched with it) over the ``iters`` timed steps).
    The steps advance the state, as an epoch's would, and so does the one
    extra step that the FLOP counter watches."""
    b = cfg.data.batch_size
    batch = trainer._on_device(trainer.train_pipe.batch_at(np.arange(b)))
    device = trainer.device

    if trainer.dual:
        def step(i):
            degrees, hflip = trainer.view_params(0, i, b)
            return trainer.train_step(trainer.state, batch, degrees, hflip, 0.5)
        loss_key = "loss1"
    else:
        def step(i):
            return trainer.train_step(trainer.state, batch)
        loss_key = "loss"

    # the warm steps' indices lie far outside the timed range
    for w in range(graphs.WARM_STEPS + 1):
        float(step(1_000_000 + w)[loss_key])
    _sync(device)
    launched = trace.totals()
    t0 = time.perf_counter()
    for i in range(iters):
        m = step(i)
    float(m[loss_key])
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    spent = trace.delta(launched)
    counted = (spent.get("warp.launches", 0), spent.get("train.graph_replays", 0))
    # FlopCounterMode dispatches every op through Python: never timed
    with FlopCounterMode(display=False) as counter:
        float(step(iters)[loss_key])
    return dt, counter.get_total_flops(), counted


def _card_ids(device: torch.device) -> set:
    """The ways nvidia-smi may name the card torch calls ``device``: its PCI
    address as nvidia-smi's ``pci.bus_id`` writes it and its UUID, as far as
    this torch's device properties give them."""
    props = torch.cuda.get_device_properties(device)
    ids = set()
    if hasattr(props, "pci_bus_id"):
        ids.add(f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:{props.pci_device_id:02X}.0")
    if getattr(props, "uuid", None):
        ids.add(f"GPU-{props.uuid}".upper())
    return ids


def power_limit(query: str, ids: set) -> Optional[float]:
    """The power limit in W of the card named by one of ``ids``, from the
    lines of ``nvidia-smi --query-gpu=name,pci.bus_id,uuid,power.limit
    --format=csv,noheader``; None where no line names that card or its limit
    is not a number. nvidia-smi lists every card of the host in its own
    order, whatever ``CUDA_VISIBLE_DEVICES`` says, so the card is matched by
    its address, never by its place in the list."""
    for line in query.splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) < 4 or not {fields[-3].upper(), fields[-2].upper()} & ids:
            continue
        try:
            return float(fields[-1].split()[0])
        except (IndexError, ValueError):
            return None
    return None


def device_info(device: torch.device) -> Dict[str, Optional[object]]:
    """The card's name as torch gives it and its power limit in W as
    nvidia-smi reads it for that card (None where the query fails); "cpu"
    and None on the CPU."""
    if device.type != "cuda":
        return {"device_name": device.type, "power_limit_w": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,pci.bus_id,uuid,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
        limit = power_limit(out.stdout, _card_ids(device))
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"device_name": torch.cuda.get_device_name(device), "power_limit_w": limit}


def step_throughput(dt: float, flops: int, device_name: str) -> Dict[str, Optional[float]]:
    """TFLOP/s of a step of ``flops`` model FLOPs in ``dt`` seconds and its
    share of the card's peak (None for a card PEAK_TFLOPS lacks), under the
    JAX bench's keys: executed FLOPs are the model FLOPs here."""
    tflops = flops / dt / 1e12
    peak = PEAK_TFLOPS.get(device_name)
    mfu = tflops / peak if peak else None
    return {
        "train_step_mfu": mfu,
        "mfu_basis": "model",
        "train_step_model_tflops_per_s": tflops,
        "train_step_tflops_per_s": tflops,
        "train_step_mfu_executed": mfu,
        "peak_tflops": peak,
        "model_flops_per_step": flops,
    }


def profiled_epoch(trainer: Trainer, epoch: int, path: str):
    """``run_epoch(epoch)`` with ``PROFILE_STEPS`` train steps from the
    middle of its train phase under torch.profiler, their Chrome trace
    written to ``path``. The profiler stays off for the other steps and
    phases: a trace of the whole CHAOS epoch is 1 GB and slows every step
    by 40%. Returns the epoch's row and what the trace cost and showed:
    ``profile_spans``, the traced steps' device time by the program span
    that launched it and their idle device time by the span open on the
    host (``core.trace.by_span``)."""
    steps = trainer.train_pipe.steps_per_epoch(trainer.cfg.data.batch_size)
    wait = max((steps - PROFILE_STEPS) // 2 - 1, 0)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=wait, warmup=1, active=PROFILE_STEPS, repeat=1))
    train_step = trainer.train_step

    def stepped(*args):
        m = train_step(*args)
        prof.step()
        return m

    trainer.train_step = stepped
    try:
        with prof:
            row = trainer.run_epoch(epoch)
    finally:
        trainer.train_step = train_step
    t0 = time.perf_counter()
    prof.export_chrome_trace(path)
    return row, {
        "profile_traced_steps": list(range(wait + 1, wait + 1 + PROFILE_STEPS)),
        "profile_trace_bytes": os.path.getsize(path),
        "profile_export_seconds": time.perf_counter() - t0,
        "profile_spans": trace.by_span(prof.events()),
    }


def _peak_memory(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def host_cc_times(volumes) -> Dict:
    """ms a volume of the host's largest-CC on ``volumes``: the native
    library, which case evaluation runs, and its plain numpy twin, each the
    median of one call a volume, and whether their outputs are equal."""
    times = {"native": [], "plain": []}
    equal = True
    for vol in volumes:
        outs = {}
        for name, fn in (("native", cc.keep_largest_connected_components),
                         ("plain", cc.keep_largest_connected_components_plain)):
            t0 = time.perf_counter()
            outs[name] = fn(vol)
            times[name].append((time.perf_counter() - t0) * 1e3)
        equal = equal and bool(np.array_equal(outs["native"], outs["plain"]))
    return {"cc_native_ms_per_volume": float(np.median(times["native"])),
            "cc_plain_ms_per_volume": float(np.median(times["plain"])),
            "cc_outputs_equal": equal, "cc_volumes": len(volumes)}


def eval_volume_bench(trainer: Trainer, cfg: TrainConfig, args, extras=None) -> int:
    """Per-volume 3D evaluation speed. One "volume eval" = batched slice
    inference through the predict program, the uint8 label fetch to the
    host (no bit-packing), keep-largest-CC, and 3D Dice/IoU/confusion on
    the host: the same work as one case of the reference's eval scripts,
    which run it as a bs=1 slice loop at "several seconds" per volume.

    Two numbers: the single-volume latency (one volume alone), and the
    batch-amortized seconds a volume when all test volumes go through one
    packed inference pass and one fetch (the in-training path)."""
    cases = list(trainer.test_cases)
    eb = cfg.data.eval_batch_size
    pipe = trainer.test_pipe

    def run(case_list):
        return evaluate_cases(
            trainer._predict_batch, trainer.state, pipe, case_list, eb, trainer.dual,
            keep_largest_cc=True, full_metrics=True, predict_all=trainer.predict_all,
        )

    log("warming up the predict programs (single-volume and full-set shapes)...")
    run(cases[:1])
    run(cases)
    log("timing single-volume latency...")
    lat = []
    for _ in range(2):
        for c in cases:
            t0 = time.perf_counter()
            run([c])
            lat.append(time.perf_counter() - t0)
    log("timing batch-amortized throughput (all volumes, one pass)...")
    thr = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(cases)
        thr.append(time.perf_counter() - t0)
    lat_med = float(np.median(lat))
    amortized = float(np.median(thr)) / len(cases)
    log("timing the host's largest-CC on the raw predicted volumes...")
    raw = infer_cases(trainer._predict_batch, trainer.state, pipe, cases, eb, trainer.dual,
                      keep_largest_cc=False, predict_all=trainer.predict_all)
    host_cc = host_cc_times([vol for vols in raw for vol in vols.values()])
    print(json.dumps({
        "metric": f"{args.task}_eval_volume_seconds",
        "value": lat_med,
        "unit": "s/volume",
        "vs_baseline": EVAL_VOLUME_BASELINE_S / lat_med,
        "task": args.task,
        # a dual co-teach state evaluates both nets a volume; --supervised
        # matches the reference eval script's single net
        "nets_evaluated": 2 if trainer.dual else 1,
        "slices_per_volume": len(pipe.case_indices(cases[0])),
        "img_size": cfg.data.img_size,
        "volumes_timed": len(cases),
        "amortized_volume_seconds": amortized,
        "includes": "batched slice inference + uint8 label fetch (no bit-packing) + "
                    "largest-CC + 3D dice/iou/confusion (host)",
        "baseline_note": "reference README.md:46: 'several seconds' per "
                         "volume; vs_baseline uses 3.0 s",
        **host_cc,
        **(extras or {}),
        "peak_memory_bytes": _peak_memory(trainer.device),
    }), flush=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-batch", type=int, default=0,
                    help="eval/predict batch size (0 = max(batch, 32))")
    ap.add_argument("--task", default="chaos", choices=sorted(TASK_POINTS),
                    help="operating point (model/resolution/dataset size)")
    ap.add_argument("--supervised", action="store_true",
                    help="benchmark the supervised comparison config "
                         "(single net, no TTA/coteach; reference ~300 s)")
    ap.add_argument("--eval-volume", action="store_true",
                    help="benchmark per-volume 3D eval speed (inference + CC + "
                         "metrics; reference: 'several seconds' per volume). "
                         "Combine with --supervised for the single-net eval-script "
                         "analogue.")
    ap.add_argument("--steps-only", action="store_true",
                    help="report the step-extrapolated metric only (skip the timed "
                         "full epoch)")
    ap.add_argument("--profile", metavar="DIR",
                    help=f"trace {PROFILE_STEPS} train steps from the middle of the timed "
                         "epoch with torch.profiler and write their Chrome trace to "
                         "DIR/trace.json")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the first CUDA card; "
                         "'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)

    # If a time limit SIGTERMs the run after the step measurement but
    # before the timed full epoch ends, flush the step-extrapolated result
    # instead of nothing (marked "partial": "steps_only").
    partial: Dict = {}

    def _flush_partial(signum, frame):
        if partial:
            print(json.dumps(partial), flush=True)
        sys.exit(0)

    previous = signal.signal(signal.SIGTERM, _flush_partial)
    try:
        return _run(args, device, partial)
    finally:
        signal.signal(signal.SIGTERM, previous)


def _run(args, device: torch.device, partial: Dict) -> int:
    shutil.rmtree(work_dir("data"), ignore_errors=True)
    shutil.rmtree(work_dir("ckpt"), ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    info = device_info(device)

    variant = "comparison" if args.supervised else "proposed"
    cfg = make_config(args.batch, variant, args.task, args.eval_batch)
    log(f"building trainer ({args.task} point: decode, upload, nets)...")
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, args.task, device)
    extras = {**info, "setup_seconds": time.perf_counter() - t0}
    if args.eval_volume:
        return eval_volume_bench(trainer, cfg, args, extras)
    log("trainer built; warm-up epoch 0 (cuDNN autotuning, first allocations)...")
    trainer.run_epoch(0)
    log("warm-up done; timing bare train steps...")

    dt, flops, (launches, replays) = time_bare_steps(trainer, cfg, BARE_STEPS)
    baseline = SUPERVISED_BASELINE_S if args.supervised else BASELINE_EPOCH_S
    epoch_slices = EPOCH_SLICES if args.task == "chaos" else len(trainer.train_pipe)
    step_epoch_s = epoch_slices * dt / args.batch
    extras.update({
        "task": args.task,
        "batch_size": args.batch,
        # bench.py's key; the packed layout's knob is fixed here (see make_config)
        "block_barrier": True,
        "train_step_epoch_seconds": step_epoch_s,
        "train_step_seconds": dt,
        "train_steps_per_epoch": trainer.train_pipe.steps_per_epoch(args.batch),
        **step_throughput(dt, flops, info["device_name"]),
        "bare_steps": BARE_STEPS,
        "warp_launches_timed": launches,
        "warp_launches_per_step": launches / BARE_STEPS,
        "graph_replays_timed": replays,
    })

    metric_name = (
        f"{args.task}_supervised_epoch_seconds"
        if args.supervised
        else f"{args.task}_coteach_epoch_seconds"
    )
    partial.update({
        "metric": metric_name,
        "value": step_epoch_s,
        "unit": "s/epoch",
        "vs_baseline": baseline / step_epoch_s,
        "partial": "steps_only",
        **extras,
    })

    if args.steps_only:
        # keep the marker: a step-extrapolated number must not read as a
        # full-epoch measurement
        value = step_epoch_s
        extras["partial"] = "steps_only"
    else:
        log("timing full epoch 1...")
        launched = trace.totals()
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
            row, cost = profiled_epoch(trainer, 1, os.path.join(args.profile, "trace.json"))
            extras.update(cost)
        else:
            row = trainer.run_epoch(1)
        value = float(row["time"])
        # the eager train steps' launches, none in the test pass or case
        # evaluation; the replayed steps' go with their graph
        spent = trace.delta(launched)
        extras["warp_launches_epoch"] = spent.get("warp.launches", 0)
        extras["graph_replays_epoch"] = spent.get("train.graph_replays", 0)
        extras["full_epoch_includes"] = (
            "train+test_eval+case reinference+checkpoint"
            if args.supervised
            else "train+test_eval+2x case reinference+checkpoint+refresh"
        )
        extras.update({k: v for k, v in row.items() if k.startswith("time_")})

    partial.clear()  # a full result follows; disarm the SIGTERM fallback
    print(json.dumps({
        "metric": metric_name,
        "value": value,
        "unit": "s/epoch",
        "vs_baseline": baseline / value,
        **extras,
        "peak_memory_bytes": _peak_memory(device),
        # the epochs run (warm-up first), as the trainer's history keeps them
        "history": trainer.history,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
