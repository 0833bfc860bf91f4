#!/usr/bin/env python3
"""Time the space axis's two ways of assembling a halo, in turns, on 2 cards.

``core.mesh.halo_rows`` returns a shard's rows of a (B, C, h, W) map with r
rows of each space neighbour above and below. Two ways to put the three
blocks together:

  cat     ``torch.cat`` of the blocks. The neighbours' rows arrive in NCHW
          (contiguous) memory, so the halo of a channels_last map comes
          out NCHW.
  format  the blocks written into one tensor in the input's memory format
          (channels_last for the nets' maps): ``core.mesh._with_halo``.

Through ``mesh.launch`` on 2 cards (one process a card, NCCL) it runs
chip_smoke.py phase 14's (a), the CHAOS point (FuseUNet-32, bf16, 256 px,
batch 8, 4 TTA views at +-60 degrees), and (c), the kidney comparison preset
(UNet-64, 512 px, batch 4), each at space 2 with 8 steps an epoch. On each
rank: one warm-up train epoch with each way, then train epochs in the turns
cat, format, format, cat, cat, format (each turn's median step, host clock
around a synchronised step), then 3 profiled steps with each way
(``chip_smoke.device_breakdown``: device time by kernel kind and the halo
exchanges' device time). It prints the card's nvidia-smi name and power
limit, then one JSON line a preset.

    python3 chip_halo_ab.py      # from the repo's root, on 2 or more cards
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import chip_smoke as smoke

TURNS = ("cat", "format", "format", "cat", "cat", "format")


def cat_halo(top, x, bottom):
    import torch

    return torch.cat([top, x, bottom], dim=2)


def format_halo(top, x, bottom):
    import torch

    fmt = (torch.channels_last if x.stride(1) == 1 or x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    r, h = top.shape[2], x.shape[2]
    out = torch.empty(x.shape[:2] + (h + 2 * r,) + x.shape[3:], dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    out[:, :, :r] = top
    out[:, :, r:r + h] = x
    out[:, :, r + h:] = bottom
    return out


WAYS = {"cat": cat_halo, "format": format_halo}


def preset_trainer(preset, rank, device, scratch):
    """The trainer of ``preset`` ("chaos": phase 14 (a); "kidney": (c)) at
    space 2 on this rank, its files under ``scratch``."""
    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.trainer import Trainer

    name = f"{preset}_rank{rank}"
    if preset == "chaos":
        cfg = smoke.space_axis_config(2)
        work = smoke.fresh_dir(os.path.join(scratch, name))
        cfg.checkpoint_dir = os.path.join(work, "ckpt")
        cfg.history_dir = os.path.join(work, "hist")
        cfg.data.tempmask_folder = "tempmasks"
        task = smoke.chaos_task(os.path.join(work, "chaos"))
    else:
        cfg = smoke.kidney_config("kidney_comparison_mask1", scratch, name)
        cfg.mesh.num_devices, cfg.mesh.extra_axes = 2, (("space", 2),)
        task = smoke.kidney_task(scratch, name)
    trainer = Trainer(cfg, task, device=device)
    trainer.label_cases = set(task.clean_case_ids())
    if mesh.space_shards() != 2:
        smoke.fail(f"{preset}: rank {rank}: the space axis is not live")
    return trainer


def ab_rank(rank, device, scratch, preset):
    """The turns and the profiles of ``preset`` on this rank (a process of
    ``mesh.launch``): {"turns": [[way, median step ms, step ms]],
    "profiles": {way: device_breakdown}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.ops.schedules import rate_schedule

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    trainer = preset_trainer(preset, rank, device, scratch)
    step_ms, last, inner = [], [], trainer.train_step

    def timed(*args):
        sync()
        t = time.perf_counter()
        out = inner(*args)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        last[:] = [args]
        return out

    trainer.train_step = timed
    epoch = [0]

    def train_epoch(way):
        mesh._with_halo = WAYS[way]
        step_ms.clear()
        rate = (rate_schedule(epoch[0], trainer.cfg.coteach.warmup_epochs)
                if trainer.dual else 0.0)
        trainer._train_epoch(epoch[0], rate)
        epoch[0] += 1
        return [statistics.median(step_ms), list(step_ms)]

    for way in WAYS:  # cuDNN's autotuning of each way's layouts
        train_epoch(way)
    turns = [[way, *train_epoch(way)] for way in TURNS]
    profiles = {}
    for way in WAYS:
        mesh._with_halo = WAYS[way]
        inner(*last[0])
        sync()
        with smoke.tagged_halos(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                inner(*last[0])
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        profiles[way] = smoke.device_breakdown(prof, 3, wall_us)
    return {"turns": turns, "profiles": profiles}


def main() -> int:
    import torch

    if torch.cuda.device_count() < 2:
        print("chip_halo_ab.py needs 2 cards", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.ops import cuda_warp

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smoke.smi_line(), flush=True)  # name, power limit: as nvidia-smi gives them
    cuda_warp.build(verbose=True)
    scratch = os.path.join(root, "build", "chip_halo_ab")
    os.makedirs(scratch, exist_ok=True)
    for preset in ("chaos", "kidney"):
        t0 = time.perf_counter()
        ranks = mesh.launch(ab_rank, smoke.space_axis_config(2), "cuda", (scratch, preset))
        means = {way: statistics.mean(t[1] for r in ranks.values() for t in r["turns"]
                                      if t[0] == way) for way in WAYS}
        print(json.dumps({
            "preset": preset, "seconds": time.perf_counter() - t0,
            "mean_of_turn_medians_ms": means, "format_over_cat": means["format"] / means["cat"],
            "turns_by_rank": {r: [t[:2] for t in res["turns"]] for r, res in ranks.items()},
            "profiles_by_rank": {r: res["profiles"] for r, res in ranks.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
