#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aide_tpu_torch) on one NVIDIA GPU.

Phases:
  1. header: torch/CUDA versions, the card's name and power limit;
  2. build the TTA warp kernel from aide_tpu_torch/csrc with nvcc;
  3. hold the kernel against its plain PyTorch version on the card
     (33/64/100/256/512 px, C in {2, 3}, both directions, degrees over ±135
     plus the ±45, ±135 and ±180 boundaries, both flips, (B, C) fills, and
     single images): max abs <= 1e-5; then past ±180 degrees (±180, ±200,
     ±217.5, ±230, ±250, ±265, ±269.5, ±269.99, ±270, ±300, ±360, ±540,
     ±720 at the same sizes, both flips, both directions, and two
     output-row windows at 256 px): exact (max abs 0), each launch's tiles
     on the global-tap path printed (source_boxes in plain PyTorch), and at
     least one launch with tiles on both paths;
  4. time the kernel at the co-teaching paths' shapes (CHAOS: forward
     (32, 256, 256, 3), inverse (64, 256, 256, 2); kidney: forward
     (16, 512, 512, 3), inverse (32, 512, 512, 2)) with a cold L2 (a 64 MB
     buffer written between runs, outside the events) and a warm one, and
     the plain version (CUDA events, medians) beside the bytes-over-bandwidth
     bound; the CHAOS step's two shapes again with degrees drawn
     seeded-uniform in ±360 and all at 265 (every image with tiles on the
     global-tap path), exact against the plain version, their global tiles
     printed; with --baseline FILE.cu (repeatable), other builds of the
     kernel's entry point are timed the same way at the ±60 degree rows,
     in turns with this one;
  5. the CHAOS path: Trainer.run(2) at the CHAOS point at full width
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
     within 5e-3. (b) the replayed step against eager at that point: from
     the state phase 5 left, 8 steps on phase 5's first 8 batches and view
     parameters, rate 0.2 for 4 steps and 0.9 for 4, run eagerly, then by
     a fresh step function that replays its CUDA graph (2 eager steps, the
     capture, 5 replays), then eagerly 3 times, the state restored in
     place before each: the largest difference of every step's metrics,
     and of the parameters, BN statistics and AMSGrad moments, between the
     replayed run and the nearest eager one at most twice the largest
     between two eager runs (0 where those agree bit for bit; at this
     width they do not: kernels that add atomically, as the bilinear
     upsample's backward, sum in another order each run), the same count,
     3 host-called launches in each eager or captured step and none in a
     replay; then 3 more replays
     under torch.profiler: 3 warp kernels a replayed step in CUPTI's
     kernel records;
  6. a small slice (32 px, base width 4, f32, TF32 off, 4 train cases) on
     the card, once with the data on the device (the fused test pass) and
     once with host batches (device_cache "off": the separate test pass and
     per-batch predictions), each against the same slice on the CPU from
     the same weights and view parameters, 2 epochs of run_epoch with
     refresh: identical refresh decisions, each with a margin (the CPU's
     dice gap at the worst-k boundary above the largest card-CPU case-dice
     difference), working labels within Dice 0.995, history metrics within
     1e-3 (relative above 1, absolute below). Then the same for the
     single-modal UNet (base width 4): 2 supervised epochs on the card
     (device-resident and host batches) against the CPU, history within
     1e-3 and the same best epochs; and 2 dual epochs warm-started from the
     CPU run's best export, with refresh, held as the FuseUNet's;
  7. the kidney protocol at full width (single-modal UNet, base width 64,
     512 px, batch 4, bf16 autocast), from the kidney_comparison_mask1 and
     kidney_proposed_mask1 presets on a synthetic single-modal task (4 train
     cases x 8 slices, 8 steps an epoch, one 8-slice test case, the clean
     case labeled): (a) Trainer.run(2) of the supervised comparison run:
     finite single-net history, a best .pkl that torch.load(weights_only=
     True) reads with its embedded history, no warp launch; (b)
     Trainer.run(2) of the dual co-teaching run warm-started from (a)'s best
     export with noise 1e-3: each net's parameters off the export at the
     noise scale and its BN stats equal to it, the bootstrap skill probe
     before the first step with no warp launch, exactly 2 warp launches a
     step and none in case evaluation, the refreshed labels as in phase 5,
     and best exports exactly when the ascending gate logged a best epoch;
  8. the paper's presets from their native files: fixture trees written
     from a seed at the paths each preset names (build/chip_smoke/*_preset/
     data), 4 train cases x 16 slices (1 labeled through the labelcase
     CSV) and 1 test case x 16 slices, then Trainer(cfg).run(2) with the
     task built from cfg.data.task, the preset otherwise as it stands:
     (a) chaos_proposed_30cases1labeled (two-modal FuseUNet-32, bf16, 256
     px, batch 4) on 16-bit DICOM pairs whose values pass 255 and palette
     PNG masks, 3 warp launches a step; (b)
     prostate_proposed_isbi3t_transfer_isbidx (UNet-64, 256 px) on NRRD
     volumes of 320 x 320 x 16, resized on the host, 2 a step; (c)
     breast_proposed_272cases25labeled (UNet-64, 384 px) on NIfTI volumes
     of 512 px, one segmentation-mask case and noisy PNG folders, 2 a step.
     Each must give finite history, its launches a step and none in case
     evaluation, 2 refresh decisions an epoch, tempmasks in the task's
     convention that a fresh pipeline reads back as the trainer's working
     labels (prostate: resized 256 -> 320 -> 256), and loadable best
     exports; it prints the epoch phases, step times, peak memory and the
     decode seconds of each SlicePipeline. (d) the kidney_proposed_mask1
     task on single-slice NIfTI files at 400 px: its train (annotator 1)
     and test (three-mask vote) pipelines at 512 px, decode only;
  9. the command line and the model zoo, through
     aide_tpu_torch.cli.main.main(argv) in process (its trainer driven as
     the phases above drive theirs): (a) train --preset synthetic_smoke as
     it stands (UNet-8, GroupNorm, f32, 64 px, batch 4, 2 views, 3 epochs;
     only the data and output directories set, under
     build/chip_smoke/cli_smoke): finite history, 2 warp launches a step and
     none in case evaluation, the refresh decisions the preset's schedule
     gives, each logged, loadable best exports; then eval and predict of
     the best export on the card (one CSV row a test case, one PNG a test
     slice, no launch), and export refusing the GroupNorm net; (b) train
     --preset chaos_proposed_30cases1labeled --set model.name=fuseunetsa
     --epochs 2 on phase 8's fixture tree (FuseUNet-32 with spatial
     attention, bf16, 256 px, batch 4): 3 launches a step, the epoch phases,
     step times and peak as phase 8 prints them; then export of the best
     export of net 1 to the reference .pkl, eval of that .pkl on the card
     and on this machine's CPU (f32, TF32 off: per-case Dice within 1e-3,
     under 0.1% of mask pixels differing) and predict on the card; (c) one
     epoch of co-teaching steps of unetsa (UNet-64) and fuseunetsaseparate
     (FuseUNet-32) at 256 px, batch 4, 4 views, bf16 (finite losses, 2 and
     3 launches a step), phase 6's card-CPU comparison for a UNet with the
     learned upsample and GroupNorm, and the supervised step at the kidney
     comparison shapes (UNet-64, 512 px, batch 4) with remat off and on:
     step ms and peak, the peak lower with remat and the first loss within
     1e-3 relative;
 10. runs that stop and resume, and the main-view augmentation: (a) at the
     CHAOS point of phase 5, Trainer.run(1), then a new Trainer with
     resume_file=<experiment>_last_full.msgpack and run(2): the restored
     parameters, BN statistics, optimizer moments and count equal the
     saved ones bit for bit, start_epoch 1 and no bootstrap probe, 3
     launches a step and none in case evaluation, epoch 2's row and refresh
     decisions held to the same run's uninterrupted epoch 2 from the same
     state (cuDNN deterministic in both; bit for bit where they are, else
     within phase 6's 1e-3) and its refresh decisions to phase 5's epoch 2
     (two runs on the card differ in the last bits, so phase 5's rows are
     compared and printed, not held), the best _full file read back equal
     to the state it saved, and the bytes the optimizer state adds to a
     best-epoch snapshot; (b) the kidney_comparison_mask1 run of phase 7
     (a) with data.augment_main=true, run(2): 2 launches a step (the image
     and the target, each one launch), the first step's augmented batch
     held to the kernel's plain version (max abs 0 on the image, equal
     argmax targets), finite history, the step median beside phase 7
     (a)'s; (c) through the CLI on a fixture tree as phase 9 (b)'s: train
     --preset chaos_proposed_30cases1labeled --epochs 1 --set
     data.augment_main=true optim.optimizer=adam optim.grad_clip_norm=1.0
     optim.weight_decay=1e-4, then the same with --epochs 2 and resume_file
     set to its _last_full ("Resuming at epoch 2" logged), 5 launches a
     step (3 TTA, 2 augment), and one epoch with optim.optimizer=sgd whose
     _last_full a new pair and optimizer read back equal to the saved
     state;
 11. the serving export at full width, through the CLI (export --format
     serve on the card: a torch.export program for the card and one for
     the host, weights baked in): the CHAOS preset's FuseUNet-32 (phase 8
     (a)'s best export) at f32 and bf16 weights and the kidney comparison
     UNet-64 (phase 7 (a)'s) at f32, each served by a fresh process that
     cannot import aide_tpu_torch (the container read with the standard
     library, the program with torch.export.load) at batches 1, 8 and 32:
     bytes, export and load s, serve ms (CUDA events, median of 20),
     images/s and peak memory; the card's program computes in bf16 on the
     card (its convolutions' dtypes and devices, its autocast region), sums
     to 1, agrees with the eager net and the host's program with the
     card's on >= 99.9% of argmax pixels; bf16 weights under 0.75x the
     f32 artifact; an artifact traced for the host alone refuses the card.
     No warp launches;
 12. the data axis: phase 5's CHAOS point through aide_tpu_torch.core.mesh.
     launch on N = fit_data_devices(8, min(cards, 4)) NCCL ranks, one
     process a card (on a machine with one card: one rank in this process
     over a real NCCL group of one, and it says that more than one rank
     was not exercised), Trainer.run(2) on each rank with its rows of each
     batch: rank 0's history held to phase 5's (dice within 0.03, losses
     within rtol 2e-2 and atol 2e-3, the epochs equal), its refresh
     decisions to phase 5's each with a margin, every rank ending with the
     same parameters, BN statistics, working labels (host and device) and
     history, the files (logs, history, exports, _last_full, tempmasks)
     written by rank 0 alone, 3 warp launches a step on every rank and the
     warp at the per-rank shapes held to its plain version on each card;
     it prints the world size, the cards, each rank's step median, peak
     and launches, the collectives a step and the gradient all-reduce's
     bytes and ms beside phase 5's step median;
 13. the net axis: phase 5's CHAOS point through aide_tpu_torch.core.mesh.
     launch with mesh.extra_axes=(("net", 2),), one process a card, rank r
     holding net r % 2 of the pair on data shard r // 2's rows: net 2 at
     data 1 on 2 cards and, with 4 cards, data 2 x net 2. Each run is held
     as phase 12's: rank 0's history to phase 5's with the cross-mesh bars,
     each refresh decision to phase 5's with a margin, the ranks of each
     net ending with equal parameters and BN statistics, every rank with
     the same history and working labels (host and device), the files
     written by rank 0 alone, 3 warp launches a step on every rank, the
     warp at the per-rank shapes held to its plain version on each card,
     and rank 0's _last_full resumed by a one-process Trainer holding the
     ranks' nets bit for bit. It prints the world, the cards and the net
     axis, each rank's step median, peak, launches and collectives a step,
     the pair exchange's bytes and ms, at data 2 the gradient all-reduce's,
     beside phase 5's and phase 12's step medians. On a machine with one
     card it checks that the net axis raises naming the cards, and says
     that the axis was not exercised there;
 14. the space axis: phase 5's CHAOS point through aide_tpu_torch.core.mesh.
     launch with the image rows split over the cards, one process a card:
     (a) mesh.extra_axes=(("space", 2),) on 2 cards and, with 4 cards, (b)
     (("net", 2), ("space", 2)). Each layout is held as phase 13's: rank
     0's history to phase 5's with the cross-mesh bars, each refresh
     decision with a margin, the ranks of each net ending with equal
     parameters and BN statistics, every rank with the same history and
     working labels, the files written by rank 0 alone, 3 warp launches a
     step on every rank, the row-windowed warp at the rank's shapes equal
     to its plain version on its card (max abs 0), and rank 0's _last_full
     resumed by a one-process Trainer bit for bit. (c) a few supervised
     steps of kidney_comparison_mask1 (UNet-64, 512 px, batch 4) at space 2
     against the same steps on one card: the losses within rtol 2e-2 and
     the peak memory of a rank under the card's. It prints each rank's step
     median, peak and launches, the collectives a step by kind (halo,
     BatchNorm, gather, gradient) with their bytes (--profile adds the
     halo exchanges' device time a step from the trace, the NCCL ms and the
     idle share), beside phase 5's step median. On a machine with one card
     it checks and times the windowed kernel at (a)'s per-rank shapes
     against its plain version and checks that the space axis raises
     naming the cards, and says that the layouts were not exercised there;
 15. the bench at its operating points on this card, each a `python -m
     aide_tpu_torch.bench` process (its files under build/chip_smoke/
     bench/): (a) the CHAOS co-teaching point at full depth (FuseUNet-32,
     bf16, 256 px, batch 8, 30 train cases x 33 slices, 10 test cases x
     33), a warm-up epoch, 16 bare steps and the timed full epoch; (b) the
     same point's per-volume eval (--eval-volume); (c) the kidney point
     (UNet-64, 512 px, batch 8) with --steps-only; (d) the CHAOS point's
     supervised comparison with --steps-only. (b) also times the host's
     largest-CC a volume on its raw predicted volumes (33 x 256 x 256),
     the native library against its plain twin, whose outputs must be
     equal. Each JSON line must parse,
     its value be finite and above 0 with vs_baseline = baseline / value
     within 2%, the card's name and power limit beside it; every timed
     bare step replayed with no host-called warp launch; MFU in (0, 1)
     against 989.5 TFLOP/s on an H100 80GB HBM3, null on a card the bench's
     table lacks; finite epoch rows; (a) 123 train steps in the timed
     epoch, 3 host-called launches in each that did not replay, with its
     phases. The model FLOPs a step must equal one image's
     forward and forward-and-backward counts on the card composed as the
     step runs them, and the card's count equal the CPU's at 64 px (cuDNN's
     convolutions counted once). It prints each line and its seconds;
 16. the algorithm-validation ladder: (a) `python -m aide_tpu_torch.
     experiments.synthetic_aide` at the flagship point at full width
     (--style xhard --protocol pseudo --two-modal --model fuseunet
     --img-size 128 --num-cases 30 --clean-cases 1 --slices-per-case 30
     --ceiling), its epochs cut to 3 a stage, in its own process (its files
     under build/chip_smoke/ladder/): every line of its output JSON, the
     summary with the JAX program's keys and the card's name and power
     limit, every stage's history finite, pseudo_label_quality in (0, 1],
     one label-quality entry a refresh epoch, the engagement verdict, 3 warp
     launches a train step in the AIDE stage and none in the others, every
     stage's export present; (b) at phase 6's small size (two-modal
     FuseUNet at base width 4, 32 px, f32, TF32 off), apply_pseudo_labels
     from one pretrain export and one AIDE epoch after it on the card and
     on the CPU: pseudo-labels equal in >= 99.9% of voxels, their quality
     within 1e-3, the same refresh decisions each with a margin, working
     labels within Dice 0.995, history metrics within 1e-3;
 17. the real-data CHAOS programs at their own point (FuseUNet-32, bf16,
     256 px, batch 4, 4 views at +-60 degrees), 3 epochs each, each in its
     own process (files under build/chip_smoke/real/): (a)
     write_reference_chaos writes a 256 px fixture tree in the reference's
     layout and its digest is taken; (b) `python -m aide_tpu_torch.
     experiments.chaos_real_1case`: the JAX program's keys and the port's,
     30 train and 50 val slices, a finite history of 3 epochs, no warp
     launch, the best export present, the card's name and power limit; (c)
     chaos_real_ladder --stage both: the naive rung 0 launches, the AIDE
     rung 3 a train step (60 steps), one label-quality entry a refresh
     epoch, the half-life warning in its log, case 10's 100 tempmasks under
     the work directory; (d) the AIDE rung warm-started from (b)'s export
     (--resume): warm_start true, launches as (c); (e) chaos_real_proposed:
     80 train slices, the bootstrap label dice equal to (c)'s initial
     pseudo quality, one oracle line a refresh, 3 launches a step; (f) the
     tree's digest unchanged; (g) in process, the ladder's AIDE rung at 64
     px, base width 4, f32, TF32 off, lr 1e-6, 2 epochs on the card and on
     the CPU from the same nets and view parameters: the seeded labels
     equal voxel for voxel, the same refresh decisions each with a margin
     (or on equal case dice), history and label quality within 1e-3.
 18. full-circle rotation: phase 5's CHAOS point with data.rotation_degree
     = 360 (TTA views in ±360 degrees, the setting for images without a
     canonical orientation), Trainer.run(2) on the card, its steps replayed
     as a CUDA graph after the first three: a finite history, 3 launches a
     train step and none elsewhere, 2 refresh decisions an epoch read back
     as in phase 5, the best exports, each step's view parameters (past
     ±180 degrees) and the tiles of its three launches that take the
     global-tap path counted (at least one), and a CUDA operation after
     the run.
 19. the decoders' 2x bilinear upsample (csrc/upsample2x.cu, built with
     nvcc): (a) both kernels bit for bit against their plain versions on
     the card, at C in {1, 3, 4, 6, 64}, H != W, H = 1, W = 1, every
     input/output dtype pair the models meet and a base address that takes
     no vector, and at the cells' launch shapes (UPSAMPLE_STEPS) in bf16
     and, at batch 8, f32; (b) each launch shape timed alone in bf16 with
     a cold L2: forward, backward, the plain versions, and ATen's kernels
     (F.interpolate and its backward) in bf16 with autocast off (the
     library yardstick) and in f32 (as autocast ran them), beside the byte
     bound, summed to the kidney and CHAOS co-teaching and CHAOS
     supervised steps; at batch 8 each bf16 backward's largest error
     against the exact gradient and the bf16 library forward's elements
     unlike the kernel's; (c) the kidney cell's step (UNet-64 pair,
     512 px, batch 8, 4 eval-mode views) replayed as a CUDA graph runs the
     eager step's upsample2x kernels a step and no ATen upsample kernel.
     It runs alone too: python3 -c "import chip_smoke;
     chip_smoke.run_upsample(None)".
A train step's launches are the kernel's host calls (the port's
``warp.launches`` counter): on one card a step replays as a CUDA graph
after 2 eager steps and a capture a shape, and a replay launches the
graph's warp kernels with no host call, so "N launches a step" holds for
the eager and captured steps, a replayed step must show none, and phase 5
(b) counts the replayed steps' kernels from a device trace. The decoders'
upsample kernels (``upsample.launches``) are held alike in every watched
train step, to what the step's nets imply (``upsample_per_step``: 24 a
co-teaching step of two four-level nets, 8 a supervised step).
Phases 3 and 4 also check and time the kernel at phase 8's, phase 9's,
phase 10's, phase 12's, phase 13's, phase 14's (with their output-row
windows), phase 15 (c)'s and phase 16's launch shapes (phase 17 launches
at phase 8 (a)'s, the CHAOS preset's).
Then the {"kernels": [...]} JSON line and, last, {"ok": true, "device":
{...}}.

Run from the repository root:
  python3 chip_smoke.py [--profile] [--baseline FILE.cu] [--data-axis]
(--data-axis runs phases 1-5 and 12-14 alone, for a machine with several
cards, and skips phases 15-19; --profile adds, after phases 5, 7 and 12-14 and in phase 9 (a) and (b), a
torch.profiler breakdown of a few more co-teaching steps of each; --baseline times another version of csrc/warp_rotate_flip.cu, for
instance an earlier commit's, beside this one in phase 4, at the rows of
±60 degrees; it may be given more than once).
It exits non-zero, printing no result, without a CUDA device, or when any
check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
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
# the warp launches of one co-teaching step of each path: (path, shape,
# inverse, launches a step). CHAOS: both modalities' views of 4 x 8 images,
# then both nets' 2-class view logits; kidney: one image's views of 4 x 4
# images, then both nets' logits
KERNEL_LAUNCHES = (
    ("chaos_coteach", (32, 256, 256, 3), False, 2),
    ("chaos_coteach", (64, 256, 256, 2), True, 1),
    ("kidney_coteach", (16, 512, 512, 3), False, 1),
    ("kidney_coteach", (32, 512, 512, 2), True, 1),
    # phase 8's presets at batch 4: the CHAOS preset's two modalities, the
    # prostate (256 px) and breast (384 px) presets' one image
    ("chaos_preset", (16, 256, 256, 3), False, 2),
    ("chaos_preset", (32, 256, 256, 2), True, 1),
    ("prostate_preset", (16, 256, 256, 3), False, 1),
    ("prostate_preset", (32, 256, 256, 2), True, 1),
    ("breast_preset", (16, 384, 384, 3), False, 1),
    ("breast_preset", (32, 384, 384, 2), True, 1),
    # phase 9 (a): synthetic_smoke through the CLI, 2 views of 4 images at
    # 64 px, where every tile of the kernel is an edge tile
    ("cli_smoke", (8, 64, 64, 3), False, 1),
    ("cli_smoke", (16, 64, 64, 2), True, 1),
    # phase 10: data.augment_main's forward warps, one launch for the images
    # of both modalities and one for the one-hot maps of every target of
    # the batch (fill 0): the CHAOS point (2 x 8 images, 3 x 8 targets; no
    # phase runs it, its bound is the reference), the CHAOS preset at batch
    # 4 through the CLI, the kidney comparison preset (1 x 4 and 1 x 4)
    ("chaos_augment", (16, 256, 256, 3), False, 1),
    ("chaos_augment", (24, 256, 256, 2), False, 1),
    ("chaos_preset_augment", (8, 256, 256, 3), False, 1),
    ("chaos_preset_augment", (12, 256, 256, 2), False, 1),
    ("kidney_augment", (4, 512, 512, 3), False, 1),
    ("kidney_augment", (4, 512, 512, 2), False, 1),
    # phase 12 on 4 ranks: each rank's 2 of the CHAOS point's 8 images (on
    # 2 ranks a rank launches at the CHAOS preset's shapes, on 1 at phase 5's)
    ("data_axis_4", (8, 256, 256, 3), False, 2),
    ("data_axis_4", (16, 256, 256, 2), True, 1),
    # phase 13: each rank of a net axis warps both modalities' views of its
    # data shard's rows and inverse-warps its own net's views alone: at
    # data 1 (2 cards) all 8 images, at data 2 (4 cards) 4
    ("net_axis_2", (32, 256, 256, 3), False, 2),
    ("net_axis_2", (32, 256, 256, 2), True, 1),
    ("net_axis_4", (16, 256, 256, 3), False, 2),
    ("net_axis_4", (16, 256, 256, 2), True, 1),
    # phase 15 (c): the bench's kidney point at batch 8, one image's views
    # of 4 x 8 images, then both nets' logits
    ("bench_kidney", (32, 512, 512, 3), False, 1),
    ("bench_kidney", (64, 512, 512, 2), True, 1),
    # phase 16: the flagship ladder's AIDE stage (two-modal FuseUNet-32,
    # 128 px, batch 8, 4 views): both modalities' views of 4 x 8 images,
    # then both nets' logits
    ("ladder_aide", (32, 128, 128, 3), False, 2),
    ("ladder_aide", (64, 128, 128, 2), True, 1),
)
# degrees past ±180 that phase 3 holds the kernel to its plain version at:
# the global-tap path from ±217.5 at 256 px, a tile's box the whole image
# near ±270, every box within BOX_SIDE again from ±300
WIDE_DEGREES = (180.0, 200.0, 217.5, 230.0, 250.0, 265.0, 269.5, 269.99, 270.0, 300.0, 360.0,
                540.0, 720.0)
# phase 4's launches at the CHAOS step's shapes past ±180 degrees: (path,
# shape, inverse, launches a step, degrees): drawn seeded-uniform in ±360
# (phase 18's setting), and all at 265, where every image has tiles on the
# global-tap path
ANGLE_LAUNCHES = (
    ("chaos_rot360", (32, 256, 256, 3), False, 2, "uniform360"),
    ("chaos_rot360", (64, 256, 256, 2), True, 1, "uniform360"),
    ("chaos_rot265", (32, 256, 256, 3), False, 2, "all265"),
    ("chaos_rot265", (64, 256, 256, 2), True, 1, "all265"),
)
# phase 14's per-rank launches, each writing 1/k of the output rows from the
# whole source (k = the space axis; rank 0's window, rows [0, 256/k), is
# timed, every rank's is checked): (path, shape, inverse, launches a step,
# k). Space 2: both modalities' views of all 8 images, both nets' logits;
# net 2 x space 2: the same forward warps, then the rank's own net's logits
WINDOW_LAUNCHES = (
    ("space_axis_2", (32, 256, 256, 3), False, 2, 2),
    ("space_axis_2", (64, 256, 256, 2), True, 1, 2),
    ("space_axis_4", (32, 256, 256, 3), False, 2, 2),
    ("space_axis_4", (32, 256, 256, 2), True, 1, 2),
)
# phase 12's per-rank launch shapes by world size: their rows above
DATA_AXIS_SHAPES = {1: "chaos_coteach", 2: "chaos_preset", 4: "data_axis_4"}
# the paths whose launches have earlier paths' shapes (and their rows in
# phase 4): the CHAOS preset with fuseunetsa and the fuseunetsaseparate
# steps at batch 4 launch as the CHAOS preset does, the unetsa steps as the
# prostate preset (one 256 px image), the resumed CHAOS point as phase 5,
# phase 10 (c)'s runs as the CHAOS preset and its augment warps
PRESET_AUGMENT = ("chaos_preset", "chaos_preset_augment")
SAME_SHAPES = {"cli_chaos": ("chaos_preset",), "zoo_fuseunetsaseparate": ("chaos_preset",),
               "zoo_unetsa": ("prostate_preset",), "chaos_resume": ("chaos_coteach",),
               "cli_resume_first": PRESET_AUGMENT, "cli_resume": PRESET_AUGMENT,
               "cli_sgd": PRESET_AUGMENT, "bench_chaos": ("chaos_coteach",),
               # phase 17: the real-data programs at the CHAOS preset's point
               "real_ladder_aide": ("chaos_preset",), "real_warm_aide": ("chaos_preset",),
               "real_proposed": ("chaos_preset",)}
# phase 8: (path, preset, the fixture tree's native px, warp launches a step)
PRESET_RUNS = (
    ("chaos_preset", "chaos_proposed_30cases1labeled", 256, 3),
    ("prostate_preset", "prostate_proposed_isbi3t_transfer_isbidx", 320, 2),
    ("breast_preset", "breast_proposed_272cases25labeled", 512, 2),
)


def _decoder_inputs(size: int):
    """The four decoder levels' upsample inputs (S, C), deepest first: the
    UNet-64's maps at ``size`` px, and equally the FuseUNet-32's fused ones
    (1024 channels at size/16, halving as the side doubles)."""
    return [((size // 16) << level, 1024 >> level) for level in range(4)]


# phase 19: the decoders' 2x upsample launches of one step, by path: (input
# (N, H, W, C), forward launches a step, backward launches a step). Each net
# of a co-teaching pair upsamples at its four levels in the train forward
# (batch 8) and its backward, and in the views' forward (4 views x 8
# images, no gradient); the supervised step is one net's train forward and
# backward. Kidney: the UNet-64 pair at 512 px; CHAOS: the FuseUNet-32 pair
# at 256 px
UPSAMPLE_STEPS = {
    "kidney_coteach": [((n, s, s, c), 2, 2 if n == 8 else 0)
                       for s, c in _decoder_inputs(512) for n in (8, 32)],
    "chaos_coteach": [((n, s, s, c), 2, 2 if n == 8 else 0)
                      for s, c in _decoder_inputs(256) for n in (8, 32)],
    "chaos_supervised": [((8, s, s, c), 1, 1) for s, c in _decoder_inputs(256)],
}
# phase 19's edge cases, kernel against plain version: (N, H, W, C) with C in
# {1, 3, 4, 6, 64}, H != W, H = 1 and W = 1
UPSAMPLE_EDGE_SHAPES = ((2, 5, 7, 1), (2, 5, 7, 3), (2, 1, 6, 4), (1, 6, 1, 6), (2, 4, 4, 64),
                        (3, 9, 5, 6), (1, 1, 1, 8))


START = time.perf_counter()


def stamp(done: str) -> None:
    print(f"{done} done at {time.perf_counter() - START:.1f} s", flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def warp_launches() -> int:
    """The TTA warp kernel's launches so far in this process (the port's
    ``warp.launches`` counter)."""
    from aide_tpu_torch.core import trace

    return trace.totals().get("warp.launches", 0)


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
    # the main paths' launch shapes, at their ±60 degrees and both flips
    for shape, inverse in sorted({(shape, inverse) for _, shape, inverse, _ in KERNEL_LAUNCHES}):
        n, s, _, c = shape
        degrees = [60.0 * (2.0 * i / (n - 1) - 1.0) for i in range(n)]
        images, degrees_t, hflip_t, fill = warp_inputs(degrees, [i % 2 for i in range(n)], s, c,
                                                       seed=n + s + c, device=device)
        table = cuda_warp.coef_table(degrees_t, hflip_t, inverse)
        got = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill, inverse=inverse)
        ref = cuda_warp.warp_plain(images, table, cuda_warp.fill_table(fill, n, c, device), inverse)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"kernel vs plain at launch shape {shape} {'inverse' if inverse else 'forward'}: "
              f"max abs {err:.3e}", flush=True)
        if not bool(torch.isfinite(got).all()) or err > 1e-5:
            fail(f"kernel disagrees with its plain version at launch shape {shape}: max abs {err}")
        worst = max(worst, err)
    # phase 14's windows: every shard's rows, held to the plain version's
    # window exactly, and to the whole launch's rows
    for shape, inverse, k in sorted({(sh, inv, k) for _, sh, inv, _, k in WINDOW_LAUNCHES}):
        worst = max(worst, window_vs_plain(cuda_warp, shape, inverse, k, device))
    return max(worst, check_wide_angles(cuda_warp, device))


def check_wide_angles(cuda_warp, device) -> float:
    """Phase 3 past ±180 degrees: the kernel exact (max abs 0) against its
    plain version at ±WIDE_DEGREES, both flips, in both directions, at
    33-512 px and C in {2, 3}, and in two output-row windows at 256 px;
    each launch's tiles on the global-tap path printed. Fails unless some
    launch ran tiles on both paths. Returns 0.0."""
    import torch

    degs = [d for a in WIDE_DEGREES for d in (a, -a)]
    degrees, hflip = degs * 2, [0.0] * len(degs) + [1.0] * len(degs)
    mixed = 0
    for s in (33, 64, 100, 256, 512):
        for c in (2, 3):
            for inverse in (False, True):
                for rows in [None] + ([(0, 128), (96, 64)] if (s, c) == (256, 3) else []):
                    images, degrees_t, hflip_t, fill = warp_inputs(degrees, hflip, s, c,
                                                                   seed=3 * s + c, device=device)
                    table = cuda_warp.coef_table(degrees_t, hflip_t, inverse)
                    fills = cuda_warp.fill_table(fill, len(degrees), c, device)
                    got = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill,
                                                     inverse=inverse, rows=rows)
                    ref = cuda_warp.warp_plain(images, table, fills, inverse, rows)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    boxes = cuda_warp.source_boxes(table, s, inverse, rows=rows)
                    n_global, n_tiles = cuda_warp.global_tiles(boxes), boxes[..., 0].numel()
                    mixed += 0 < n_global < n_tiles
                    print(f"kernel vs plain past 180 degrees N={len(degrees)} {s:3d}px C={c} "
                          f"{'inverse' if inverse else 'forward'}"
                          f"{f' rows {list(rows)}' if rows else ''}: max abs {err:.3e}, "
                          f"{n_global} of {n_tiles} tiles on the global-tap path", flush=True)
                    if not bool(torch.isfinite(got).all()) or err != 0.0:
                        fail(f"kernel disagrees with its plain version past 180 degrees at "
                             f"{s}px C={c} inverse={inverse} rows {rows}: max abs {err}")
    if not mixed:
        fail("no launch past 180 degrees ran tiles on both of the kernel's paths")
    return 0.0


def window_vs_plain(cuda_warp, shape, inverse, k, device, seed=0) -> float:
    """The kernel's k output-row windows of a launch at ``shape`` (±60
    degrees, both flips) against the plain version's windows: fails unless
    each is equal to it and to the whole launch's rows. Returns 0.0."""
    import torch

    n, s, _, c = shape
    degrees = [60.0 * (2.0 * i / (n - 1) - 1.0) for i in range(n)]
    images, degrees_t, hflip_t, fill = warp_inputs(degrees, [i % 2 for i in range(n)], s, c,
                                                   seed=n + s + c + seed, device=device)
    table = cuda_warp.coef_table(degrees_t, hflip_t, inverse)
    fills = cuda_warp.fill_table(fill, n, c, device)
    whole = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill, inverse=inverse)
    for shard in range(k):
        rows = (shard * s // k, s // k)
        got = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill, inverse=inverse,
                                         rows=rows)
        ref = cuda_warp.warp_plain(images, table, fills, inverse, rows)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        sliced = bool(torch.equal(got, whole[:, rows[0]:rows[0] + rows[1]]))
        print(f"windowed kernel vs plain at {shape} {'inverse' if inverse else 'forward'} rows "
              f"[{rows[0]}, {rows[0] + rows[1]}): max abs {err:.3e}, equal to the whole "
              f"launch's rows: {sliced}", flush=True)
        if err != 0.0 or not sliced:
            fail(f"windowed kernel at {shape} rows {rows}: max abs {err} against its plain "
                 f"version, equal to the whole launch's rows: {sliced}")
    return 0.0


def raw_launch(lib, images, table, fills, inverse, out, rows=None):
    """One launch of a built library's warp_rotate_flip_f32 (the entry
    point with the output-row window), uncounted."""
    import torch

    n, s, _, c = images.shape
    row0, nr = rows or (0, s)
    err = lib.warp_rotate_flip_f32(images.data_ptr(), out.data_ptr(), table.data_ptr(),
                                   fills.data_ptr(), n, s, c, int(inverse), row0, nr,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"baseline kernel launch failed: CUDA error {err}")


def launch_degrees(angles: str, n: int) -> list:
    """A timed launch's n degrees: "60" the main path's ±60 spread evenly,
    "all265" n times 265, "uniform360" drawn seeded-uniform in ±360."""
    import torch

    if angles == "60":
        return [60.0 * (2.0 * i / (n - 1) - 1.0) for i in range(n)]
    if angles == "all265":
        return [265.0] * n
    g = torch.Generator(device="cpu").manual_seed(n)
    return (torch.rand(n, generator=g, dtype=torch.float64) * 720.0 - 360.0).tolist()


def time_kernel(cuda_warp, device, baselines=()):
    """Phase 4: kernel and plain-version times at the co-teaching paths'
    shapes (KERNEL_LAUNCHES, WINDOW_LAUNCHES at ±60 degrees, and
    ANGLE_LAUNCHES past ±180), cold (L2 flushed before each run) and warm.
    Baseline libraries, given as (name, ctypes library) pairs, are timed in
    turns with the kernel: b1, b2, ..., kernel, kernel, ..., b2, b1."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def flush():
        scratch.fill_(1.0)

    rows = []
    launches = ([(path, shape, inverse, per_step, None, "60")
                 for path, shape, inverse, per_step in KERNEL_LAUNCHES]
                + [(path, shape, inverse, per_step, k, "60")
                   for path, shape, inverse, per_step, k in WINDOW_LAUNCHES]
                + [(path, shape, inverse, per_step, None, angles)
                   for path, shape, inverse, per_step, angles in ANGLE_LAUNCHES])
    for path, shape, inverse, per_step, k, angles in launches:
        n, s, _, c = shape
        window = (0, s // k) if k else None
        degrees = launch_degrees(angles, n)
        images, degrees, hflip, fill = warp_inputs(degrees, [i % 2 for i in range(n)], s, c,
                                                   seed=7, device=device)
        table = cuda_warp.coef_table(degrees, hflip, inverse)
        fills = cuda_warp.fill_table(fill, n, c, device)
        got = cuda_warp.launch(images, table, fills, inverse, window)
        ref = cuda_warp.warp_plain(images, table, fills, inverse, window)
        err = float((got - ref).abs().max())
        if err > (1e-5 if window is None and angles == "60" else 0.0):
            fail(f"kernel disagrees at the main path shape {shape} rows {window}: {err}")
        n_global = cuda_warp.global_tiles(cuda_warp.source_boxes(table, s, inverse, rows=window))
        versions = {"kernel": lambda: cuda_warp.launch(images, table, fills, inverse, window)}
        out = torch.empty((n, window[1] if window else s, s, c), device=device)
        # an older build may trap past ±180 degrees: baselines run at ±60 only
        for name, lib in baselines if angles == "60" else ():
            versions[name] = (lambda lib=lib: raw_launch(lib, images, table, fills, inverse, out,
                                                         window))
            versions[name]()
            torch.cuda.synchronize()
            base_err = float((out - ref).abs().max())
            if base_err > 1e-5:
                fail(f"baseline {name} disagrees at the main path shape {shape}: {base_err}")
        names = [name for name in versions if name != "kernel"]
        order = names + ["kernel", "kernel"] + names[::-1]
        cold = {k: [] for k in versions}
        warm = {k: [] for k in versions}
        for k in order:
            cold[k].append(time_cuda(versions[k], flush=flush))
            warm[k].append(time_cuda(versions[k]))
        k_ms = statistics.mean(cold["kernel"])
        k_warm = statistics.mean(warm["kernel"])
        w_ms = time_cuda(lambda: cuda_warp.warp_rotate_flip(images, degrees, hflip, fill, inverse,
                                                            window), flush=flush)
        p_ms = time_cuda(lambda: cuda_warp.warp_plain(images, table, fills, inverse, window),
                         runs=20)
        nbytes = (cuda_warp.window_bytes_moved(table, s, c, inverse, window) if window
                  else cuda_warp.bytes_moved(shape))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        label = ("inverse" if inverse else "forward") + (f" rows {list(window)}" if window else "")
        if angles != "60":
            label += f" at degrees {angles}"
        print(f"timing {label} {shape}: kernel cold {k_ms:.4f} ms, warm {k_warm:.4f} ms, "
              f"wrapper cold {w_ms:.4f} ms, plain {p_ms:.4f} ms, bytes {nbytes}, "
              f"bound {bound_ms * 1e3:.2f} us ({bound_ms / k_ms:.1%} of the bound cold, "
              f"{bound_ms / k_warm:.1%} warm), {n_global} tiles on the global-tap path",
              flush=True)
        row = dict(path=path, shape=shape, inverse=inverse, rows=window, per_step=per_step, ms=k_ms,
                   ms_warm=k_warm, wrapper_ms=w_ms, plain_ms=p_ms, bytes=nbytes,
                   bound_ms=bound_ms, max_abs_err=err, degrees=angles, global_tiles=n_global)
        if names:
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
    # phases 5-11 train on one card whatever the machine holds, so that
    # their numbers compare across machines; phase 12 sets the data axis
    cfg.mesh.num_devices = 1
    return cfg


def chaos_task(root: str):
    """Phase 5's task: 4 train cases x 16 slices at 256 px, one 16-slice
    test case, the first case clean."""
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask

    return SyntheticTask(
        root=root, tempmask_folder="tempmasks", two_modal=True, num_cases=4,
        slices_per_case=16, size=256, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
        test_case_offset=100, seed=7,
    )


def release_device_memory() -> None:
    """Free what earlier runs left on the card before a run's peak is
    measured: a driven trainer holds bound methods of itself as attributes
    (drive() restores them so), a reference cycle that ``del`` alone does
    not free, and the allocator counts its tensors until it is collected."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


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


def check_best_exports(trainer, best_epochs) -> list:
    """The best-epoch exports exist exactly when the gate logged a best
    epoch (``best_epochs``, 1-based); each .pkl loads with
    torch.load(weights_only=True), holds its net's state-dict keys and the
    last best epoch. Returns the export paths."""
    import torch

    from aide_tpu_torch.engine import checkpoint as ckpt

    cfg = trainer.cfg
    nums = (1, 2) if trainer.dual else (None,)
    paths = [ckpt.best_net_path(cfg.checkpoint_dir, cfg.experiment_name, n) for n in nums]
    if not best_epochs:
        if any(os.path.exists(p) for p in paths):
            fail(f"no best epoch was logged, yet an export exists: {paths}")
        print("best exports: none (the gate logged no best epoch)", flush=True)
        return []
    for path, net in zip(paths, trainer.state.nets):
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if set(obj["net"]) != set(net.state_dict()) or obj["epoch"] != best_epochs[-1]:
            fail(f"{path} does not hold the net's state dict of epoch {best_epochs[-1]}")
        print(f"best export {os.path.basename(path)}: epoch {obj['epoch']}, "
              f"traincase_dice {obj['traincase_dice']:.6f}, {os.path.getsize(path)} bytes", flush=True)
    return paths


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


def watched(inner, steps: list):
    """``inner``, a train step, timed on the host clock around a
    synchronised call; each call appends (ms, the warp kernel's host-called
    launches in it, whether it replayed the step's CUDA graph, the upsample
    kernels' host-called launches in it) to ``steps``."""
    import torch

    from aide_tpu_torch.core import trace

    def step(*args):
        torch.cuda.synchronize()
        before = trace.totals()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        spent = trace.delta(before)
        steps.append((ms, spent.get("warp.launches", 0), spent.get("train.graph_replays", 0) == 1,
                      spent.get("upsample.launches", 0)))
        return out

    return step


def stepped(steps: list) -> dict:
    """``watched``'s records as a run's step_ms, step_launches, replayed,
    replays and step_upsample."""
    return dict(step_ms=[s[0] for s in steps], step_launches=[s[1] for s in steps],
                replayed=[s[2] for s in steps], replays=sum(s[2] for s in steps),
                step_upsample=[s[3] for s in steps])


def upsample_per_step(trainer) -> int:
    """The decoders' upsample kernels the host calls in one eager train
    step of ``trainer``, from its nets' modules: each bilinear
    ``blocks.Upsample2x`` of a net on this rank runs once in the net's
    train forward and once in its backward, once more in the backward
    where remat recomputes its up block, and in a co-teaching step once in
    the views' forward (24 a step of a co-teaching pair of four-level
    nets, 8 a supervised step of one)."""
    from aide_tpu_torch.engine.state import DualTrainState, NetRankState
    from aide_tpu_torch.models.blocks import Upsample2x

    state = trainer.state
    passes = (2 + bool(trainer.cfg.model.remat)
              + isinstance(state, (DualTrainState, NetRankState)))
    return passes * sum(isinstance(m, Upsample2x) for net in state.nets for m in net.modules())


def upsample_step_launches(path: str) -> int:
    """Forward and backward upsample launches of one step of an
    UPSAMPLE_STEPS path."""
    return sum(f + b for _, f, b in UPSAMPLE_STEPS[path])


def drive(trainer, cuda_warp, epochs: int = 2, runner=None) -> dict:
    """Trainer.run(epochs) with each step's time (host clock around a
    synchronised step), host-called warp launches and whether it replayed
    its graph (``watched``), the warp launches of each train epoch and of
    the whole run (the counter's increase over it), the
    epochs the best-checkpoint gate logged, each refresh's case dice
    {(epoch, net index): {case: dice}}, and the peak of
    max_memory_allocated. ``runner(epochs)`` runs the epochs instead of
    ``trainer.run`` when given (a subclass's own run)."""
    import torch

    steps, train_launches, best_epochs, case_dice = [], [], [], {}
    inner_step, inner_epoch, inner_gate, inner_refresh = (
        trainer.train_step, trainer._train_epoch, trainer._maybe_checkpoint,
        trainer._refresh_labels)
    timed_step = watched(inner_step, steps)

    def counted_epoch(*args):
        before = warp_launches()
        out = inner_epoch(*args)
        train_launches.append(warp_launches() - before)
        return out

    def gate(epoch, *args, **kw):
        saved = inner_gate(epoch, *args, **kw)
        if saved:
            best_epochs.append(epoch + 1)
        return saved

    def refresh(epoch, traincase):
        for n in traincase:
            case_dice[epoch, n] = {r.case_id: r.dice for r in traincase[n]}
        return inner_refresh(epoch, traincase)

    trainer.train_step, trainer._train_epoch, trainer._maybe_checkpoint, trainer._refresh_labels = (
        timed_step, counted_epoch, gate, refresh)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    launched = warp_launches()
    rows = (runner or trainer.run)(epochs)
    torch.cuda.synchronize()
    launches = warp_launches() - launched
    peak = torch.cuda.max_memory_allocated()
    trainer.train_step, trainer._train_epoch, trainer._maybe_checkpoint, trainer._refresh_labels = (
        inner_step, inner_epoch, inner_gate, inner_refresh)
    spe = trainer.train_pipe.steps_per_epoch(trainer.cfg.data.batch_size)
    step_ms = [s[0] for s in steps]
    values = [v for row in rows for v in row.values()]
    ran = epochs - trainer.start_epoch  # a resumed run goes on from start_epoch
    if len(rows) != epochs or len(step_ms) != ran * spe or not all(
            math.isfinite(v) for v in values):
        fail(f"run({epochs}) gave non-finite or missing history "
             f"({len(rows)} rows, {len(step_ms)} steps)")
    # the median after the first epoch; of a single epoch, after its first step
    return dict(rows=rows, **stepped(steps), upsample_per_step=upsample_per_step(trainer),
                spe=spe, train_launches=train_launches,
                launches=launches, outside=launches - sum(train_launches),
                best_epochs=best_epochs, peak=peak, case_dice=case_dice,
                steady=statistics.median(step_ms[spe:] or step_ms[1:]))


def print_run(name, run) -> None:
    for row in run["rows"]:
        print(f"{name} epoch {row['epoch']}: " + json.dumps(row), flush=True)
        print(f"{name} epoch {row['epoch']} phases (s): " + json.dumps(
            {k: row[k] for k in ("time_train", "time_test", "time_cases", "time_cases_fetch",
                                 "time_cases_host", "time_ckpt", "time_refresh", "time")}),
            flush=True)
    n = len(run["step_ms"])
    print(f"{name}: {n} steps, first step {run['step_ms'][0]:.1f} ms, median step after the "
          f"first epoch {run['steady']:.3f} ms, max_memory_allocated {run['peak']} bytes, "
          f"{run['replays']} replayed as a CUDA graph, host-called warp launches "
          f"{run['launches']} ({run['outside']} outside the train epochs), best epochs "
          f"{run['best_epochs']}", flush=True)


def launch_fault(run, per_step, augment: int = 0):
    """None where the host called the warp kernel ``per_step`` times in
    each train step that did not replay its graph and in none that did,
    ``augment`` times a step in the train epochs outside the step
    (``data.augment_main``), and nowhere else, and the upsample kernels
    ``run["upsample_per_step"]`` times in each step that did not replay
    and in none that did; else what differs."""
    n = len(run["step_ms"])
    want = [0 if r else per_step for r in run["replayed"]]
    around = sum(run.get("train_launches", [run["launches"]])) - sum(run["step_launches"])
    want_up = [0 if r else run["upsample_per_step"] for r in run["replayed"]]
    if (run["step_launches"] == want and around == augment * n and run["outside"] == 0
            and run["step_upsample"] == want_up):
        return None
    return (f"warp kernel launched {run['step_launches']} times in {n} steps "
            f"({run['replays']} replayed), {around} times around them and {run['outside']} "
            f"outside the train epochs; expected {want}, {augment * n} and 0; upsample "
            f"kernels launched {run['step_upsample']} times in the steps, expected {want_up}")


def check_launches(name, run, per_step, augment: int = 0) -> None:
    fault = launch_fault(run, per_step, augment)
    if fault:
        fail(f"{name}: {fault}")


def run_slice(cuda_warp, scratch):
    """Phase 5: the CHAOS path at full width, cut in depth only:
    Trainer.run(2) with case evaluation, the checkpoint gate and refresh."""
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = chaos_config()
    cfg.checkpoint_dir = fresh_dir(os.path.join(scratch, "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(scratch, "hist"))
    cfg.data.tempmask_folder = "tempmasks"
    task = chaos_task(fresh_dir(os.path.join(scratch, "chaos")))
    # release the blocks phases 3-4 left cached before the trainer allocates:
    # the allocator counts a large block it does not split in full, so the
    # peak would depend on what the earlier phases allocated
    release_device_memory()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, task)
    trainer.label_cases = set(task.clean_case_ids())  # as bench.py does
    setup_s = time.perf_counter() - t0
    if trainer.device.type != "cuda":
        fail(f"Trainer chose {trainer.device}, not the card")
    run = drive(trainer, cuda_warp)
    print_run("chaos", run)
    if len(trainer.refresh_log) != 2 * 2:
        fail(f"expected 2 refresh decisions an epoch, got {trainer.refresh_log}")
    check_refresh(trainer)
    check_best_exports(trainer, run["best_epochs"])
    check_launches("chaos", run, 3)
    if run["upsample_per_step"] != upsample_step_launches("chaos_coteach"):
        fail(f"chaos: {run['upsample_per_step']} upsample launches a step from the nets, "
             f"{upsample_step_launches('chaos_coteach')} in UPSAMPLE_STEPS")
    check_unfused_test(trainer, run["rows"][-1])
    print(f"chaos: setup {setup_s:.2f} s", flush=True)
    return trainer, run


def state_leaves(state) -> dict:
    """Every tensor a train step updates, by name, as copies on the card:
    the nets' parameters and BN statistics and the optimizer's moments."""
    out = {}
    for k, net in enumerate(state.nets):
        for name, t in net.state_dict().items():
            out[f"net{k}.{name}"] = t.detach().clone()
        for name, p in net.named_parameters():
            for m in state.optimizer.MOMENTS:
                out[f"net{k}.{name}.{m}"] = state.optimizer.state[p][m].clone()
    return out


def largest_gap(a: dict, b: dict) -> dict:
    """Max abs difference of each tensor of ``a`` and ``b`` (same keys)."""
    return {k: float((a[k].double() - b[k].double()).abs().max()) if a[k].numel() else 0.0
            for k in a}


def run_graph_vs_eager(trainer) -> dict:
    """Phase 5 (b): the CHAOS co-teaching step at full width replayed as a
    CUDA graph against eager, from the state phase 5 left (module
    docstring)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aide_tpu_torch.core import trace
    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine import graphs, steps

    cfg, state = trainer.cfg, trainer.state
    b, n = cfg.data.batch_size, 8
    tree = ckpt.state_tree(state)
    batches = [trainer._on_device(trainer.train_pipe.batch_at(np.arange(k * b, (k + 1) * b)))
               for k in range(n)]
    views = [trainer.view_params(0, k, b) for k in range(n)]
    rates = [0.2] * (n // 2) + [0.9] * (n - n // 2)

    def arm(replay: bool):
        ckpt.restore_state_tree(state, tree)
        step = steps.make_coteach_train_step(trainer.two_modal, cfg)
        replayable, log, metrics = graphs.replayable, [], []
        if not replay:
            graphs.replayable = lambda state, device: False
        try:
            timed = watched(step, log)
            for k in range(n):
                out = timed(state, batches[k], *views[k], rates[k])
                metrics.append({name: v.clone() for name, v in out.items()})
        finally:
            graphs.replayable = replayable
        torch.cuda.synchronize()
        flat = {f"step{k}.{name}": v for k, m in enumerate(metrics) for name, v in m.items()}
        return dict(stepped(log), upsample_per_step=upsample_per_step(trainer),
                    values={**flat, **state_leaves(state)},
                    count=state.optimizer.count, step=step)

    replayed, eagers = arm(True), [arm(False) for _ in range(3)]
    groups = {"metrics": lambda k: k.startswith("step"), "state": lambda k: not k.startswith("step")}

    def spread(a, b) -> dict:
        gaps = largest_gap(a["values"], b["values"])
        return {g: max(v for k, v in gaps.items() if inside(k)) for g, inside in groups.items()}

    pairs = [spread(a, b) for i, a in enumerate(eagers) for b in eagers[i + 1:]]
    twin = {g: max(p[g] for p in pairs) for g in groups}
    near = [spread(replayed, e) for e in eagers]
    gap = {g: min(p[g] for p in near) for g in groups}
    exact = not any(twin.values())
    over = {g: (gap[g], twin[g]) for g in groups if gap[g] > (0.0 if exact else 2 * twin[g])}
    counts = [replayed["count"]] + [e["count"] for e in eagers]
    print(f"phase 5 (b): {n} steps at the CHAOS point, rate {rates[0]} then {rates[-1]}, "
          f"largest difference by group (metrics of every step; parameters, BN statistics, "
          f"moments): eager runs among themselves {twin}, the replayed run "
          f"({replayed['replays']} replays) from the nearest eager one {gap}; counts {counts}; "
          f"step ms eager {statistics.median(eagers[0]['step_ms'][3:]):.3f}, replayed "
          f"{statistics.median(replayed['step_ms'][3:]):.3f}", flush=True)
    if over or len(set(counts)) != 1:
        fail(f"phase 5 (b): the replayed step differs from eager past twice the eager runs' own "
             f"difference: {over}, counts {counts}")
    for name, run in (("replayed", replayed), *(("eager", e) for e in eagers)):
        fault = launch_fault(dict(run, launches=sum(run["step_launches"]), outside=0), 3)
        if fault:
            fail(f"phase 5 (b) {name}: {fault}")
    if replayed["replays"] != n - graphs.WARM_STEPS - 1:
        fail(f"phase 5 (b): {replayed['replays']} of {n} steps replayed")

    # the warp kernels the card runs in replayed steps, from CUPTI's records
    step, k = replayed["step"], 3
    torch.cuda.synchronize()
    before = trace.totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(k):
            step(state, batches[i], *views[i], rates[-1])
        torch.cuda.synchronize()
    spent = trace.delta(before)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = sum(1 for name in names if "warp_rotate_flip_kernel" in name)
    print(f"phase 5 (b): {k} more replayed steps under torch.profiler: "
          f"{spent.get('train.graph_replays', 0)} replays, {kernels} warp kernels in CUPTI's "
          f"records ({kernels / k:g} a step), {spent.get('warp.launches', 0)} host-called "
          "launches", flush=True)
    if (spent.get("train.graph_replays", 0) != k or spent.get("warp.launches", 0) != 0
            or kernels != 3 * k):
        fail(f"phase 5 (b): replayed steps ran {kernels} warp kernels in {k} steps, expected "
             f"{3 * k}; counters {spent}; {len(names)} device records, the first "
             f"{sorted(set(names))[:8]}")
    del step, replayed, eagers
    release_device_memory()
    return {"steps": n, "eager_vs_eager": twin, "replayed_vs_eager": gap,
            "bit_for_bit": not any(gap.values()), "profiled_replays": k,
            "replayed_warp_kernels": kernels, "replayed_warp_kernels_per_step": kernels / k}


def kidney_config(preset: str, scratch: str, name: str):
    """Phase 7's configuration: the preset as it stands, with the data
    paths the synthetic task does not read (the CSV files and data.root)
    cleared, and this run's own output directories."""
    from aide_tpu_torch.cli.presets import get_preset

    cfg = get_preset(preset)
    cfg.mesh.num_devices = 1  # one card (chaos_config)
    d = cfg.data
    d.root = d.train_csv = d.test_csv = d.traincase_csv = d.testcase_csv = d.labelcase_csv = ""
    d.task = "synthetic"
    d.tempmask_folder = "tempmasks"
    cfg.checkpoint_dir = fresh_dir(os.path.join(scratch, name, "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(scratch, name, "hist"))
    return cfg


def kidney_task(scratch: str, name: str):
    """The kidney presets' shapes on the synthetic single-modal task: 4
    train cases x 8 slices at 512 px (8 steps an epoch at batch 4), one
    8-slice test case, the first case clean."""
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask

    return SyntheticTask(
        root=fresh_dir(os.path.join(scratch, name, "data")), tempmask_folder="tempmasks",
        two_modal=False, num_cases=4, slices_per_case=8, size=512, noisy_fraction=0.5,
        clean_cases=1, num_test_cases=1, test_case_offset=100, seed=7,
    )


def check_warm_start(trainer, path, noise) -> None:
    """Each net's parameters sit off the export by noise of the configured
    scale (the difference's std within 20% of noise * the leaf's population
    std, on leaves of 1,000 elements or more), its BN stats equal the
    export's, and the two nets differ."""
    import torch

    from aide_tpu_torch.engine import checkpoint as ckpt

    sd = ckpt.load_net(path)
    ratios = []
    for net in trainer.state.nets:
        for name, p in net.named_parameters():
            src = sd[name].to(p.device)
            if src.numel() >= 1000:
                want = noise * float(src.std(correction=0))
                ratios.append(float((p.detach() - src).std()) / want)
        for name, buf in net.named_buffers():
            if not torch.equal(buf, sd[name].to(buf.device)):
                fail(f"warm start: BN buffer {name} differs from the export")
    nets = trainer.state.nets
    same = all(torch.equal(a, b) for a, b in zip(nets[0].parameters(), nets[1].parameters()))
    print(f"warm start from {os.path.basename(path)}: noise std / ({noise} * leaf std) over "
          f"{len(ratios)} leaves in [{min(ratios):.4f}, {max(ratios):.4f}]; BN stats equal the "
          f"export's; nets differ: {not same}", flush=True)
    if same or not ratios or max(abs(r - 1.0) for r in ratios) > 0.2:
        fail("warm start: the nets are not the export plus noise of the configured scale")


def run_kidney(cuda_warp, scratch):
    """Phase 7: the kidney protocol at full width. (a) the supervised
    comparison run, then (b) the dual co-teaching run warm-started from
    (a)'s best export."""
    import torch

    from aide_tpu_torch.engine.trainer import Trainer

    release_device_memory()
    cfg = kidney_config("kidney_comparison_mask1", scratch, "kidney_sup")
    trainer = Trainer(cfg, kidney_task(scratch, "kidney_sup"))
    if trainer.device.type != "cuda" or trainer.dual:
        fail(f"the supervised kidney run is dual={trainer.dual} on {trainer.device}")
    sup = drive(trainer, cuda_warp)
    print_run("kidney supervised", sup)
    want = {"epoch", "train_loss", "train_dice_sum", "test_loss", "test_dice_sum",
            "traincase_dice1", "testcase_dice1"}
    got = {k for k in sup["rows"][0] if not k.startswith("time")}
    if got != want:
        fail(f"the supervised history has keys {sorted(got)}, not the single-net schema")
    check_launches("kidney supervised", sup, 0)
    paths = check_best_exports(trainer, sup["best_epochs"])
    if not paths:
        fail("the supervised kidney run wrote no best export to warm-start from")
    obj = torch.load(paths[0], map_location="cpu", weights_only=True)
    timeless = [{k: v for k, v in r.items() if not k.startswith("time")}
                for r in sup["rows"][: obj["epoch"]]]
    if obj["history"] != timeless:
        fail("the supervised export's embedded history differs from the run's")
    print(f"kidney supervised export: {len(obj['history'])} history rows embedded", flush=True)
    sup["exports"] = paths
    del trainer
    release_device_memory()

    cfg = kidney_config("kidney_proposed_mask1", scratch, "kidney_dual")
    cfg.resume_file = paths[0]
    task = kidney_task(scratch, "kidney_dual")
    trainer = Trainer(cfg, task)
    trainer.label_cases = set(task.clean_case_ids())
    if trainer.device.type != "cuda" or not trainer.dual:
        fail(f"the warm-started kidney run is dual={trainer.dual} on {trainer.device}")
    check_warm_start(trainer, paths[0], cfg.coteach.warm_start_noise)
    probes = []
    inner_probe = trainer._bootstrap_skill_probe

    def probe():
        before = warp_launches()
        inner_probe()
        probes.append((trainer.state.step, warp_launches() - before))

    trainer._bootstrap_skill_probe = probe
    dual = drive(trainer, cuda_warp)
    trainer._bootstrap_skill_probe = inner_probe
    print_run("kidney co-teaching", dual)
    print(f"kidney co-teaching: bootstrap probe {trainer.engagement_probe} "
          f"(optimizer step, warp launches) {probes}", flush=True)
    if probes != [(0, 0)]:
        fail(f"the bootstrap probe did not run once before the first step without a launch: {probes}")
    if len(trainer.refresh_log) != 2 * 2:
        fail(f"expected 2 refresh decisions an epoch, got {trainer.refresh_log}")
    check_refresh(trainer)
    check_best_exports(trainer, dual["best_epochs"])
    check_launches("kidney co-teaching", dual, 2)
    return trainer, sup, dual


def timed_pipelines(pipeline_cls, decode_s):
    """A stand-in for ``pipeline_cls`` that records the seconds of each
    construction (decode, resize, working labels) in ``decode_s``."""

    def build(*args, **kw):
        t = time.perf_counter()
        pipe = pipeline_cls(*args, **kw)
        decode_s.append(time.perf_counter() - t)
        return pipe

    return build


def check_preset_labels(trainer) -> None:
    """The tempmasks on disk are in the task's convention (CHAOS: PNG at 63;
    breast: PNG at 255; prostate: one whole-case NRRD volume at the native
    size); a fresh SlicePipeline built from the tree holds the trainer's
    working labels (prostate: resized to the native size and back, as the
    CPU tests hold the JAX package to); the device labels equal the host's."""
    import numpy as np

    from aide_tpu_torch.data.io import nrrd, png
    from aide_tpu_torch.data.pipeline import SlicePipeline
    from aide_tpu_torch.data.tasks import build_task
    from aide_tpu_torch.data.tasks.base import resize_mask
    from aide_tpu_torch.data.tasks.prostate import read_volume

    pipe, task, cfg = trainer.train_pipe, trainer.task, trainer.cfg
    fresh = SlicePipeline(build_task(cfg), pipe.specs, cfg.data.img_size, cfg.data.data_mean,
                          cfg.data.data_std, working_labels=True)
    files = 0
    for net in (1, 2):
        want = pipe.labels.get(net).copy()
        for case in pipe.cases:
            idxs = pipe.case_indices(case)
            paths = sorted({task.tempmask_path(pipe.specs[i], net) for i in idxs})
            if not os.path.exists(paths[0]):
                continue
            files += len(paths)
            if task.name == "prostate":
                vol = nrrd.read_nrrd(paths[0])[0]
                native = read_volume(os.path.join(task.root, pipe.specs[idxs[0]].mask_path)).shape
                if len(paths) != 1 or vol.shape != native or not set(np.unique(vol)) <= {0, 1}:
                    fail(f"prostate tempmask {paths} is not one 0/1 volume of shape {native}")
                for i in idxs:
                    want[i] = resize_mask(resize_mask(want[i], native[1:]), cfg.data.img_size)
            else:
                scale = 63 if task.name == "chaos" else 255
                for path in paths:
                    if not path.endswith(".png") or not set(np.unique(png.read_mask(path))) <= {0, scale}:
                        fail(f"{task.name} tempmask {path} is not a PNG at 0/{scale}")
        if not np.array_equal(fresh.labels.get(net), want):
            fail(f"{task.name}: a fresh pipeline's labels of net {net} differ from the trainer's")
        dev = pipe._device_labels[f"target{net}"].cpu().numpy()
        if not np.array_equal(dev, pipe.labels.get(net)):
            fail(f"{task.name}: device labels of net {net} differ from the host's after the sync")
    if not files:
        fail(f"{task.name}: the refresh wrote no tempmask")
    print(f"{task.name} refresh: {trainer.refresh_log}; {files} tempmask files in the task's "
          f"convention; a fresh pipeline holds the trainer's working labels; device labels equal "
          f"the host's", flush=True)


def run_presets(cuda_warp, scratch):
    """Phase 8: the CHAOS, prostate and breast proposed presets as they
    stand, on fixture trees in their native formats, Trainer(cfg).run(2)
    with the task built from the config; then the kidney preset's task and
    pipelines on a NIfTI tree, decode only."""
    import numpy as np

    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.data.fixtures import write_fixture_tree
    from aide_tpu_torch.engine import trainer as trainer_mod

    runs = {}
    for path, preset, native, per_step in PRESET_RUNS:
        work = fresh_dir(os.path.join(scratch, path))
        cfg = get_preset(preset, os.path.join(work, "data"))
        cfg.mesh.num_devices = 1  # one card (chaos_config)
        cfg.checkpoint_dir = os.path.join(work, "ckpt")
        cfg.history_dir = os.path.join(work, "hist")
        t0 = time.perf_counter()
        write_fixture_tree(cfg, train_cases=4, test_cases=1, slices=16, size=native, labeled=1, seed=7)
        print(f"{path}: preset {preset} as it stands ({cfg.model.name}, base width "
              f"{cfg.model.base_width or 'default'}, {cfg.model.compute_dtype}, {cfg.data.img_size} px, "
              f"batch {cfg.data.batch_size}, eval batch {cfg.data.eval_batch_size}); depth cut to 4 train "
              f"cases x 16 slices (1 labeled through the labelcase CSV), 1 test case x 16 slices, "
              f"native {native} px, run(2); fixture tree written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        release_device_memory()
        decode_s, inner = [], trainer_mod.SlicePipeline
        trainer_mod.SlicePipeline = timed_pipelines(inner, decode_s)
        t0 = time.perf_counter()
        try:
            trainer = trainer_mod.Trainer(cfg)
        finally:
            trainer_mod.SlicePipeline = inner
        setup_s = time.perf_counter() - t0
        if trainer.device.type != "cuda" or trainer.task.name != cfg.data.task or not trainer.dual:
            fail(f"{path}: Trainer built {trainer.task.name} dual={trainer.dual} on {trainer.device}")
        if not trainer.label_cases:
            fail(f"{path}: the labelcase CSV gave no labeled case")
        run = drive(trainer, cuda_warp)
        print_run(path, run)
        print(f"{path}: setup {setup_s:.2f} s, SlicePipeline.__init__ decode s (train, test) "
              f"{[round(v, 3) for v in decode_s]}, labeled {sorted(trainer.label_cases)}", flush=True)
        if len(trainer.refresh_log) != 2 * 2:
            fail(f"{path}: expected 2 refresh decisions an epoch, got {trainer.refresh_log}")
        check_preset_labels(trainer)
        run["exports"] = check_best_exports(trainer, run["best_epochs"])
        check_launches(path, run, per_step)
        run["decode_s"] = decode_s
        runs[path] = run
        del trainer
    # (d) kidney, decode only: the annotator-1 train manifest and the voted
    # test manifest of a single-slice NIfTI tree at 400 px, resized to 512
    from aide_tpu_torch.data.io import nifti
    from aide_tpu_torch.data.pipeline import SlicePipeline
    from aide_tpu_torch.data.tasks import build_task
    from aide_tpu_torch.data.tasks.base import resize_mask

    cfg = get_preset("kidney_proposed_mask1", fresh_dir(os.path.join(scratch, "kidney_decode")))
    write_fixture_tree(cfg, train_cases=8, test_cases=4, size=400, seed=7)
    task = build_task(cfg)
    t0 = time.perf_counter()
    train = SlicePipeline(task, task.load_manifest(cfg.data.train_csv), cfg.data.img_size,
                          working_labels=True)
    t1 = time.perf_counter()
    test = SlicePipeline(task, task.load_manifest(cfg.data.test_csv, train=False), cfg.data.img_size)
    t2 = time.perf_counter()
    votes = []
    for spec in test.specs:
        masks = [nifti.read_nifti(os.path.join(cfg.data.root, m))[0] for m in spec.extras["all_masks"]]
        votes.append(resize_mask((np.mean(masks, axis=0) > 0.5).astype(np.uint8), cfg.data.img_size))
    first = nifti.read_nifti(os.path.join(cfg.data.root, train.specs[0].mask_path))[0]
    if (type(task).__name__ != "KidneyTask" or train.images[0].shape != (8, 512, 512, 3)
            or not np.array_equal(test.targets, np.stack(votes))
            or not np.array_equal(train.targets[0], resize_mask((first > 0.5).astype(np.uint8), 512))
            or not train.targets.any() or not test.targets.any()):
        fail("kidney decode: the pipelines do not hold annotator 1's masks and the vote at 512 px")
    print(f"kidney decode (400 -> 512 px, NIfTI): train {len(train)} slices (annotator 1) in "
          f"{t1 - t0:.3f} s, test {len(test)} slices (three-mask vote) in {t2 - t1:.3f} s", flush=True)
    return runs


def cli_train(cuda_warp, argv):
    """``main(["train", *argv])`` of the port's CLI, in process, with the
    trainer it builds driven as ``drive`` drives one (the launch count set
    to 0 just before its run and read just after), on one card
    (``mesh.num_devices=1``: the CLI's default trains on every visible
    card, one process each). Returns (trainer, run)."""
    from aide_tpu_torch.cli.main import main as cli
    from aide_tpu_torch.engine import trainer as trainer_mod

    base, driven = trainer_mod.Trainer, []

    class Driven(base):
        def run(self, num_epochs=None):
            run = drive(self, cuda_warp, num_epochs, runner=lambda n: base.run(self, n))
            driven.append((self, run))
            return run["rows"]

    release_device_memory()
    trainer_mod.Trainer = Driven
    try:
        rc = cli(["train", *argv, "--set", "mesh.num_devices=1"])
    finally:
        trainer_mod.Trainer = base
    if rc != 0 or len(driven) != 1:
        fail(f"train {argv}: rc {rc}, {len(driven)} driven runs")
    return driven[0]


def cli_command(cuda_warp, argv) -> tuple:
    """``main(argv)`` of the port's CLI, in process: (its JSON output, the
    seconds it took). It must return 0 without a warp launch."""
    from aide_tpu_torch.cli.main import main as cli

    buf = io.StringIO()
    launched = warp_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    seconds = time.perf_counter() - t0
    if rc != 0 or warp_launches() != launched:
        fail(f"{argv[0]} {argv[1:]}: rc {rc}, {warp_launches() - launched} warp launches")
    return json.loads(buf.getvalue()), seconds


def read_case_csv(path: str) -> dict:
    """{case: [Dice, IoU, TP, TN, FP, FN]} of an eval CSV with the reference
    header."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    if not lines or lines[0] != "Patient_case,Dice,IoU,TP,TN,FP,FN":
        fail(f"{path} lacks the reference header: {lines[:1]}")
    return {row.split(",")[0]: [float(v) for v in row.split(",")[1:]] for row in lines[1:]}


def png_masks(folder: str) -> dict:
    """{relative path: mask} of every PNG under ``folder``."""
    from aide_tpu_torch.data.io import png

    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in sorted(files):
            if f.endswith(".png"):
                path = os.path.join(dirpath, f)
                out[os.path.relpath(path, folder)] = png.read_mask(path)
    return out


def check_eval_outputs(name, out, checkpoint, cases, slices) -> dict:
    """An eval's CSV holds one row a test case, and its masks one PNG a
    test slice. Returns the CSV's rows."""
    rows = read_case_csv(os.path.join(out, os.path.basename(checkpoint).split(".")[0] + ".csv"))
    masks = png_masks(os.path.join(out, "generated_masks"))
    if sorted(rows) != sorted(cases) or len(masks) != slices:
        fail(f"{name}: eval wrote rows {sorted(rows)} and {len(masks)} masks for cases "
             f"{sorted(cases)} of {slices} slices")
    return rows


def run_cli_smoke(cuda_warp, scratch, extra=(), profile=False):
    """Phase 9 (a): ``train --preset synthetic_smoke`` as it stands, then
    ``eval`` and ``predict`` of its best export on the card; ``export``
    refuses the GroupNorm net. ``profile`` adds profile_steps of the
    trained pair."""
    from aide_tpu_torch.cli.main import main as cli

    work = fresh_dir(os.path.join(scratch, "cli_smoke"))
    argv = ["--preset", "synthetic_smoke", "--set", f"data.root={work}/data",
            f"checkpoint_dir={work}/ckpt", f"history_dir={work}/hist", *extra]
    trainer, run = cli_train(cuda_warp, argv)
    cfg = trainer.cfg
    print(f"cli_smoke: train --preset synthetic_smoke ({cfg.model.name}, norm {cfg.model.norm}, "
          f"{cfg.model.compute_dtype}, {cfg.data.img_size} px, batch {cfg.data.batch_size}, "
          f"{cfg.data.num_tta_views} views, {len(trainer.train_pipe)} train slices, "
          f"{cfg.num_epochs} epochs)", flush=True)
    print_run("cli_smoke", run)
    if trainer.device.type != "cuda" or not trainer.dual or len(run["rows"]) != cfg.num_epochs:
        fail(f"cli_smoke: {len(run['rows'])} epochs, dual={trainer.dual} on {trainer.device}")
    check_launches("cli_smoke", run, 2)
    want = 2 * sum(trainer._is_refresh_epoch(e) for e in range(cfg.num_epochs))
    with open(os.path.join(cfg.history_dir, f"{cfg.experiment_name}.log")) as fh:
        logged = sum("modify for net" in line for line in fh)
    if len(trainer.refresh_log) != want or logged != want:
        fail(f"cli_smoke: the schedule gives {want} refresh decisions; {len(trainer.refresh_log)} "
             f"made, {logged} logged")
    check_refresh(trainer)
    paths = check_best_exports(trainer, run["best_epochs"])
    if not paths:
        fail("cli_smoke: no best export")
    if profile:
        profile_steps("cli_smoke co-teaching", trainer)
    cases, slices = list(trainer.test_cases), len(trainer.test_pipe)
    del trainer
    release_device_memory()
    summary, eval_s = cli_command(cuda_warp, ["eval", *argv, "--checkpoint", paths[0],
                                              "--output", f"{work}/eval"])
    check_eval_outputs("cli_smoke", f"{work}/eval", paths[0], cases, slices)
    pred, pred_s = cli_command(cuda_warp, ["predict", *argv, "--checkpoint", paths[0],
                                           "--output", f"{work}/pred"])
    if pred["slices"] != slices or len(png_masks(f"{work}/pred")) != slices:
        fail(f"cli_smoke: predict wrote {pred} for {slices} slices")
    try:
        cli(["export", *argv, "--checkpoint", paths[0], "--output", f"{work}/net.pkl"])
    except ValueError as err:
        refused = str(err)
    else:
        fail("cli_smoke: export of a GroupNorm net did not refuse")
    print(f"cli_smoke: eval of {os.path.basename(paths[0])} on the card {json.dumps(summary)} in "
          f"{eval_s:.2f} s; predict {json.dumps(pred)} in {pred_s:.2f} s; export refused: "
          f"{refused}", flush=True)
    return run


def run_cli_chaos(cuda_warp, scratch, extra=(), profile=False):
    """Phase 9 (b): ``train --preset chaos_proposed_30cases1labeled --set
    model.name=fuseunetsa --epochs 2`` on phase 8's fixture tree at full
    width; then ``export`` of the best export of net 1, ``eval`` of the
    exported .pkl on the card and on this machine's CPU (f32, TF32 off:
    per-case Dice within 1e-3, under 0.1% of mask pixels differing), and
    ``predict`` on the card. ``profile`` adds profile_steps of the trained
    pair."""
    import numpy as np
    import torch

    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.data.fixtures import write_fixture_tree

    preset = "chaos_proposed_30cases1labeled"
    work = fresh_dir(os.path.join(scratch, "cli_chaos"))
    data = os.path.join(work, "data")
    write_fixture_tree(get_preset(preset, data), train_cases=4, test_cases=1, slices=16,
                       size=256, labeled=1, seed=7)
    argv = ["--preset", preset, "--data-root", data, "--set", "model.name=fuseunetsa",
            f"checkpoint_dir={work}/ckpt", f"history_dir={work}/hist", *extra]
    trainer, run = cli_train(cuda_warp, argv + ["--epochs", "2"])
    cfg = trainer.cfg
    print(f"cli_chaos: train --preset {preset} --set model.name=fuseunetsa ({cfg.model.name}, "
          f"base width {cfg.model.base_width or 'default'}, {cfg.model.compute_dtype}, "
          f"{cfg.data.img_size} px, batch {cfg.data.batch_size}) on the fixture tree of phase 8",
          flush=True)
    print_run("cli_chaos", run)
    if (trainer.device.type != "cuda" or not trainer.dual or cfg.model.name != "fuseunetsa"
            or not hasattr(trainer.state.nets[0], "modal1_sa5")):
        fail(f"cli_chaos: Trainer built {cfg.model.name} dual={trainer.dual} on {trainer.device}")
    check_launches("cli_chaos", run, 3)
    paths = check_best_exports(trainer, run["best_epochs"])
    if not paths:
        fail("cli_chaos: no best export")
    if profile:
        profile_steps("cli_chaos co-teaching", trainer)
    keys = set(trainer.state.nets[0].state_dict())
    cases, slices = list(trainer.test_cases), len(trainer.test_pipe)
    del trainer
    release_device_memory()

    pkl = f"{work}/net1.pkl"
    cli_command(cuda_warp, ["export", *argv, "--checkpoint", paths[0], "--output", pkl])
    obj = torch.load(pkl, map_location="cpu", weights_only=True)
    tracked = {k[: -len("running_var")] + "num_batches_tracked" for k in keys
               if k.endswith("running_var")}
    if set(obj) != {"net", "loss", "epoch"} or set(obj["net"]) != keys | tracked:
        fail(f"cli_chaos: the exported {pkl} is not the reference layout of the net")
    f32 = ["--set", "model.compute_dtype=float32", "--checkpoint", pkl]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card, card_s = cli_command(cuda_warp, ["eval", *argv, *f32, "--output", f"{work}/eval_card"])
        cpu, cpu_s = cli_command(cuda_warp, ["eval", *argv, *f32, "--output", f"{work}/eval_cpu",
                                             "--device", "cpu"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rows = {k: check_eval_outputs(f"cli_chaos eval on the {k}", f"{work}/eval_{k}", pkl, cases,
                                  slices) for k in ("card", "cpu")}
    dice_gap = max(abs(rows["card"][c][0] - rows["cpu"][c][0]) for c in cases)
    masks = {k: png_masks(f"{work}/eval_{k}/generated_masks") for k in ("card", "cpu")}
    differ = sum(int(np.count_nonzero(masks["card"][k] != m)) for k, m in masks["cpu"].items())
    total = sum(m.size for m in masks["cpu"].values())
    print(f"cli_chaos: eval of the exported .pkl, f32 and TF32 off: card {json.dumps(card)} in "
          f"{card_s:.2f} s, CPU {json.dumps(cpu)} in {cpu_s:.2f} s; per-case Dice gap "
          f"{dice_gap:.3e}, mask pixels differing {differ} of {total} ({differ / total:.3e})",
          flush=True)
    if dice_gap > 1e-3 or differ >= 1e-3 * total:
        fail(f"cli_chaos: the card's eval disagrees with the CPU's: Dice gap {dice_gap}, "
             f"{differ} of {total} mask pixels")
    pred, pred_s = cli_command(cuda_warp, ["predict", *argv, "--checkpoint", pkl,
                                           "--output", f"{work}/pred"])
    if pred["slices"] != slices or len(png_masks(f"{work}/pred")) != slices:
        fail(f"cli_chaos: predict wrote {pred} for {slices} slices")
    print(f"cli_chaos: predict {json.dumps(pred)} in {pred_s:.2f} s", flush=True)
    return run


def zoo_steps(cuda_warp, scratch, name, base_width, per_step) -> dict:
    """Phase 9 (c): one epoch of co-teaching steps (3 cases x 8 slices, 6
    steps) of ``name`` at full width, 256 px, batch 4, 4 views, bf16
    autocast: finite losses and ``per_step`` warp launches a step."""
    import torch

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer
    from aide_tpu_torch.models import is_two_modal

    cfg = chaos_config()
    cfg.model.name, cfg.model.base_width = name, base_width
    cfg.data.batch_size = 4
    cfg.checkpoint_dir = fresh_dir(os.path.join(scratch, f"zoo_{name}", "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(scratch, f"zoo_{name}", "hist"))
    task = SyntheticTask(
        root=fresh_dir(os.path.join(scratch, f"zoo_{name}", "data")), tempmask_folder="tempmasks",
        two_modal=is_two_modal(name), num_cases=3, slices_per_case=8, size=256,
        noisy_fraction=0.5, clean_cases=1, num_test_cases=1, test_case_offset=100, seed=7,
    )
    release_device_memory()
    trainer = Trainer(cfg, task)
    steps, inner = [], trainer.train_step
    trainer.train_step = watched(inner, steps)
    torch.cuda.reset_peak_memory_stats()
    launched = warp_launches()
    m = trainer._train_epoch(0, 0.5)
    launches = warp_launches() - launched
    trainer.train_step = inner
    run = dict(**stepped(steps), upsample_per_step=upsample_per_step(trainer), launches=launches,
               outside=0, peak=torch.cuda.max_memory_allocated())
    step_ms = run["step_ms"]
    run["steady"] = statistics.median(step_ms[1:])
    print(f"zoo_{name}: {len(step_ms)} co-teaching steps ({name}, base width {base_width}, 256 px, "
          f"batch 4, 4 views, bf16): losses {m['loss1']:.4f}/{m['loss2']:.4f}, first step "
          f"{step_ms[0]:.1f} ms, median of the rest {run['steady']:.3f} ms, max_memory_allocated "
          f"{run['peak']} bytes, {run['replays']} steps replayed, host-called warp launches "
          f"{launches}", flush=True)
    if len(step_ms) != 6 or not all(math.isfinite(v) for v in m.values()):
        fail(f"zoo_{name}: {len(step_ms)} steps, metrics {m}")
    check_launches(f"zoo_{name}", run, per_step)
    del trainer
    return run


def remat_peak() -> dict:
    """Phase 9 (c): the supervised step at the kidney comparison shapes
    (kidney_comparison_mask1: UNet-64, 512 px, batch 4, bf16 autocast) from
    the same weights and batch, remat off then on: the first step's loss,
    the median of 5 more steps and the peak of max_memory_allocated."""
    import torch

    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.engine import steps as steps_mod
    from aide_tpu_torch.engine.state import TrainState
    from aide_tpu_torch.engine.trainer import init_net
    from aide_tpu_torch.ops.schedules import make_optimizer

    cfg = get_preset("kidney_comparison_mask1")
    b, s = cfg.data.batch_size, cfg.data.img_size
    g = torch.Generator().manual_seed(7)
    batch = {"image": torch.randn((b, s, s, 3), generator=g).cuda(),
             "target": (torch.rand((b, s, s), generator=g) < 0.3).long().cuda()}
    weights, out = None, {}
    for remat in (False, True):
        cfg.model.remat = remat
        release_device_memory()
        net = init_net(cfg.model, cfg.seed)
        if weights is None:
            weights = {k: v.clone() for k, v in net.state_dict().items()}
        net.load_state_dict(weights)
        net = net.cuda().to(memory_format=torch.channels_last)
        state = TrainState(net, make_optimizer(list(net.parameters()), cfg.optim, 10, 10))
        step = steps_mod.make_supervised_train_step(False, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(6):
            t = time.perf_counter()
            losses.append(float(step(state, batch)["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[remat] = dict(loss=losses[0], step_ms=statistics.median(ms[1:]),
                          peak=torch.cuda.max_memory_allocated())
        del state, net, step
    rel = abs(out[True]["loss"] - out[False]["loss"]) / abs(out[False]["loss"])
    print(f"remat at the kidney comparison shapes ({cfg.model.name}, {s} px, batch {b}, "
          f"{cfg.model.compute_dtype}, supervised): off {json.dumps(out[False])}, on "
          f"{json.dumps(out[True])}; peak {out[True]['peak'] / out[False]['peak']:.3f}x, step "
          f"{out[True]['step_ms'] / out[False]['step_ms']:.3f}x, first-step loss relative "
          f"difference {rel:.3e}", flush=True)
    if out[True]["peak"] >= out[False]["peak"] or rel > 1e-3:
        fail(f"remat: the peak did not fall or the loss moved: {out}")
    return {"off": out[False], "on": out[True]}


def run_zoo(cuda_warp, scratch) -> tuple:
    """Phase 9 (c): the attention FuseUNet and UNet on the card, the learned
    upsample and GroupNorm against this machine's CPU, remat's peak."""
    import torch

    runs = {"zoo_unetsa": zoo_steps(cuda_warp, scratch, "unetsa", 64, 2),
            "zoo_fuseunetsaseparate": zoo_steps(cuda_warp, scratch, "fuseunetsaseparate", 32, 3)}
    torch.backends.cudnn.allow_tf32 = False
    small_dual_vs_cpu(scratch, "unet", two_modal=False,
                      options={"learned_bilinear": True, "norm": "group"}, caches=("auto",))
    torch.backends.cudnn.allow_tf32 = True
    return runs, remat_peak()


# ------------------------------- phase 10 -------------------------------


def tree_equal(got: dict, want: dict) -> bool:
    """Two state trees (engine.checkpoint.state_tree) with the same leaves,
    dtypes and values, empty maps included."""
    import numpy as np

    if got.keys() != want.keys():
        return False
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            if not isinstance(g, dict) or not tree_equal(g, w):
                return False
        elif not (np.asarray(g).dtype == np.asarray(w).dtype and np.array_equal(g, w)):
            return False
    return True


def snapshots_equal(a: dict, b: dict) -> bool:
    """Two engine.checkpoint snapshots bit for bit on the card: every
    state-dict tensor, every optimizer moment, the count."""
    import torch

    if a["count"] != b["count"] or a["chain"] != b["chain"]:
        return False
    for sa, sb in zip(a["nets"] + a["moments"], b["nets"] + b["moments"]):
        if sa.keys() != sb.keys():
            return False
        for k, x in sa.items():
            y = sb[k]
            pairs = zip(x.values(), y.values()) if isinstance(x, dict) else [(x, y)]
            if not all(torch.equal(u, v) for u, v in pairs):
                return False
    return True


def run_resume_chaos(cuda_warp, scratch, chaos, chaos_log):
    """Phase 10 (a): the CHAOS point stopped after epoch 1 and resumed from
    its _last_full file for epoch 2. Two runs of the same epochs on the card
    differ in the last bits (its atomics; the first epoch here against
    phase 5's shows how far), so the resumed epoch 2 is held to the same
    run's uninterrupted epoch 2 from the same state, both with cuDNN's
    deterministic algorithms, and to phase 5's (``chaos``, ``chaos_log``)
    refresh decisions; its rows' distance from phase 5's is printed."""
    import torch

    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine.trainer import Trainer

    work = fresh_dir(os.path.join(scratch, "chaos_resume"))
    cfg = chaos_config()
    cfg.checkpoint_dir = os.path.join(work, "ckpt")
    cfg.history_dir = os.path.join(work, "hist")
    cfg.data.tempmask_folder = "tempmasks"
    data = os.path.join(work, "data")
    release_device_memory()
    first = Trainer(cfg, chaos_task(data))
    first.label_cases = set(first.task.clean_case_ids())
    part1 = drive(first, cuda_warp, epochs=1)
    check_launches("chaos_resume epoch 1", part1, 3)
    spread = worst_difference(part1["rows"], chaos["rows"][:1])
    print(f"chaos_resume: epoch 1 against phase 5's: refresh decisions {first.refresh_log} / "
          f"{[e for e in chaos_log if e[0] == 0]}, worst metric difference {spread:.3e}", flush=True)
    saved = ckpt.snapshot(first.state)
    opt_bytes = sum(t.numel() * t.element_size() for net in saved["moments"]
                    for named in net.values() for t in named.values())
    net_bytes = sum(t.numel() * t.element_size() for sd in saved["nets"] for t in sd.values())
    # the best _full file: epoch 1 is the first best, saved after its train
    # steps, so it holds the state run(1) ended with; its sidecar replays it
    best = ckpt.full_path(cfg.checkpoint_dir, cfg.experiment_name)
    with open(best, "rb") as fh:
        best_tree = ckpt.msgpack_restore(fh.read())
    best_meta = ckpt.read_meta(best)
    if (part1["best_epochs"] != [1] or best_meta["next_epoch"] != 0
            or not tree_equal(best_tree, ckpt.state_tree(first.state))):
        fail(f"chaos_resume: the best _full file (best epochs {part1['best_epochs']}, next_epoch "
             f"{best_meta.get('next_epoch')}) does not hold the state it saved")
    print(f"chaos_resume: run(1) then the best _full file read back equal to the state "
          f"({os.path.getsize(best)} bytes); a best-epoch snapshot holds {net_bytes} bytes of state "
          f"dicts and {opt_bytes} bytes of optimizer moments", flush=True)
    last = ckpt.full_path(cfg.checkpoint_dir, cfg.experiment_name, last=True)
    t0 = time.perf_counter()
    trainer = Trainer(cfg.override([f"resume_file={last}"]), chaos_task(data))
    setup_s = time.perf_counter() - t0
    trainer.label_cases = set(trainer.task.clean_case_ids())
    restored = ckpt.snapshot(trainer.state, clone=False)
    if trainer.start_epoch != 1 or not snapshots_equal(restored, saved):
        fail(f"chaos_resume: start_epoch {trainer.start_epoch}; the restored state differs from "
             "the saved one")
    del saved, restored
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the same run, uninterrupted: epoch 2 from the state in memory (the
        # resumed trainer has read the tempmasks this epoch rewrites)
        straight = first.run_epoch(1)
        straight_log = [e for e in first.refresh_log if e[0] == 1]
        del first
        release_device_memory()
        probes = []
        inner_probe = trainer._bootstrap_skill_probe
        trainer._bootstrap_skill_probe = lambda: probes.append(1) or inner_probe()
        run = drive(trainer, cuda_warp, epochs=2)
        trainer._bootstrap_skill_probe = inner_probe
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print_run("chaos_resume", run)
    check_launches("chaos_resume", run, 3)
    check_refresh(trainer)
    with open(os.path.join(cfg.history_dir, f"{cfg.experiment_name}.log")) as fh:
        resumed_logged = "Resuming at epoch 2" in fh.read()
    row = run["rows"][1]
    bitwise = sorted(k for k in straight if not k.startswith("time") and row[k] != straight[k])
    worst = worst_difference([row], [straight])
    phase5 = worst_difference([row], chaos["rows"][1:2])
    want_log = [e for e in chaos_log if e[0] == 1]
    print(f"chaos_resume: restore bit for bit in {setup_s:.2f} s of setup, start_epoch 1, bootstrap "
          f"probes {len(probes)}, 'Resuming at epoch 2' logged {resumed_logged}; epoch 2 against the "
          f"same run's uninterrupted epoch 2 (cuDNN deterministic): refresh decisions "
          f"{trainer.refresh_log} / {straight_log}, keys differing in any bit {bitwise or 'none'}, "
          f"worst metric difference {worst:.3e} (relative above 1, absolute below); against phase "
          f"5's epoch 2: refresh decisions {want_log}, worst metric difference {phase5:.3e} (epoch "
          f"1's run-to-run spread {spread:.3e})", flush=True)
    if (probes or not resumed_logged or trainer.refresh_log != straight_log
            or trainer.refresh_log != want_log or worst > 1e-3):
        fail("chaos_resume: the resumed epoch 2 is not the uninterrupted one")
    run.update(bitwise=not bitwise, worst=worst, phase5=phase5, spread=spread,
               snapshot_opt_bytes=opt_bytes, snapshot_net_bytes=net_bytes)
    del trainer
    return run


def check_augment_plain(cuda_warp, trainer, batch, degrees, hflip, out) -> None:
    """The augmented batch of a step against the kernel's plain version on
    the same inputs: the images (both modalities in one warp) with max abs
    0, the targets' warped one-hot maps (fill 0) with equal argmax."""
    import torch
    import torch.nn.functional as F

    from aide_tpu_torch.engine import steps

    two = trainer.two_modal
    images = steps.batch_images(batch, two)
    names = ("modal1", "modal2") if two else ("image",)
    k, (b, _, _, c) = len(images), images[0].shape
    table = cuda_warp.coef_table(degrees.repeat(k), hflip.repeat(k), False)
    fills = cuda_warp.fill_table(torch.cat(steps.batch_fills(batch, two)), k * b, c, images[0].device)
    ref = cuda_warp.warp_plain(torch.cat(images), table, fills, False)
    img_err = float((torch.cat([out[n] for n in names]) - ref).abs().max())
    tnames = [t for t in steps.TARGETS if t in batch]
    nc = trainer.cfg.model.num_classes
    onehot = torch.cat([F.one_hot(batch[t].long(), nc).float() for t in tnames])
    kt = len(tnames)
    ttable = cuda_warp.coef_table(degrees.repeat(kt), hflip.repeat(kt), False)
    tref = cuda_warp.warp_plain(onehot, ttable, cuda_warp.fill_table(0.0, kt * b, nc, onehot.device),
                                False).argmax(dim=-1)
    tgot = torch.cat([out[t] for t in tnames])
    differ = int((tgot != tref.to(tgot.dtype)).sum())
    print(f"augment vs plain at the launch shapes {tuple(ref.shape)} and {tuple(onehot.shape)}: "
          f"images max abs {img_err:.3e}, target pixels differing {differ} of {tgot.numel()}",
          flush=True)
    if img_err != 0.0 or differ:
        fail(f"the augment warp disagrees with its plain version: {img_err}, {differ} pixels")


def run_augment_supervised(cuda_warp, scratch, kidney_sup):
    """Phase 10 (b): phase 7 (a)'s supervised kidney run with
    data.augment_main."""
    from aide_tpu_torch.engine.trainer import Trainer

    release_device_memory()
    cfg = kidney_config("kidney_comparison_mask1", scratch, "kidney_augment")
    cfg.data.augment_main = True
    trainer = Trainer(cfg, kidney_task(scratch, "kidney_augment"))
    if trainer.dual or trainer.augment_batch is None:
        fail("kidney_augment: not a supervised run with the augmentation")
    inner, checked = trainer.augment_batch, []

    def augment(batch, degrees, hflip):
        out = inner(batch, degrees, hflip)
        if not checked:
            before = warp_launches()  # the comparison's own launches do not count
            check_augment_plain(cuda_warp, trainer, batch, degrees, hflip, out)
            checked.append(warp_launches() - before)
        return out

    trainer.augment_batch = augment
    run = drive(trainer, cuda_warp)
    trainer.augment_batch = inner
    print_run("kidney_augment", run)
    check_launches("kidney_augment", run, 0, augment=2)
    print(f"kidney_augment: median step {run['steady']:.3f} ms with augment_main against phase 7 "
          f"(a)'s {kidney_sup['steady']:.3f} ms without ({run['steady'] / kidney_sup['steady']:.3f}x)",
          flush=True)
    if checked != [0]:
        fail(f"kidney_augment: the plain comparison ran {checked}")
    del trainer
    return run


def run_cli_resume(cuda_warp, scratch):
    """Phase 10 (c): the CHAOS preset through the CLI with augment_main and
    adam behind clipping and decay, stopped after epoch 1 and resumed from
    its _last_full; then one sgd epoch whose _last_full a new pair and
    optimizer read back."""
    import copy

    import torch

    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.data.fixtures import write_fixture_tree
    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine.state import DualTrainState
    from aide_tpu_torch.ops.schedules import make_optimizer

    preset = "chaos_proposed_30cases1labeled"
    work = fresh_dir(os.path.join(scratch, "cli_resume"))
    data = os.path.join(work, "data")
    write_fixture_tree(get_preset(preset, data), train_cases=4, test_cases=1, slices=16,
                       size=256, labeled=1, seed=7)
    opts = ["data.augment_main=true", "optim.optimizer=adam", "optim.grad_clip_norm=1.0",
            "optim.weight_decay=1e-4"]
    argv = ["--preset", preset, "--data-root", data, "--set", *opts,
            f"checkpoint_dir={work}/ckpt", f"history_dir={work}/hist"]
    trainer, first = cli_train(cuda_warp, argv + ["--epochs", "1"])
    cfg = trainer.cfg
    print_run("cli_resume epoch 1", first)
    check_launches("cli_resume epoch 1", first, 3, augment=2)
    last = ckpt.full_path(cfg.checkpoint_dir, cfg.experiment_name, last=True)
    del trainer
    trainer, run = cli_train(cuda_warp, argv + ["--epochs", "2", "--set", f"resume_file={last}"])
    print_run("cli_resume", run)
    check_launches("cli_resume", run, 3, augment=2)
    with open(os.path.join(cfg.history_dir, f"{cfg.experiment_name}.log")) as fh:
        logged = "Resuming at epoch 2" in fh.read()
    opt = trainer.state.optimizer
    print(f"cli_resume: train --preset {preset} --set {' '.join(opts)}: epoch 1, then --epochs 2 "
          f"from {os.path.basename(last)}: start_epoch {trainer.start_epoch}, 'Resuming at epoch "
          f"2' logged {logged}, optimizer {type(opt).__name__} (clip {opt.grad_clip_norm}, decay "
          f"{opt.weight_decay}) at count {opt.count}", flush=True)
    if trainer.start_epoch != 1 or not logged or opt.NAME != "adam":
        fail("cli_resume: the run did not resume at epoch 2 under adam")
    del trainer
    sgd_argv = ["--preset", preset, "--data-root", data, "--set", "data.augment_main=true",
                "optim.optimizer=sgd", f"checkpoint_dir={work}/ckpt_sgd",
                f"history_dir={work}/hist_sgd"]
    trainer, sgd = cli_train(cuda_warp, sgd_argv + ["--epochs", "1"])
    print_run("cli_sgd", sgd)
    check_launches("cli_sgd", sgd, 3, augment=2)
    path = ckpt.full_path(trainer.cfg.checkpoint_dir, trainer.cfg.experiment_name, last=True)
    with open(path, "rb") as fh:
        written = ckpt.msgpack_restore(fh.read())
    # a new pair and optimizer (the trainer's nets copied and zeroed) read it
    nets = [copy.deepcopy(net) for net in trainer.state.nets]
    with torch.no_grad():
        for t in (t for net in nets for t in net.state_dict().values()):
            t.zero_()
    spe = trainer.train_pipe.steps_per_epoch(trainer.cfg.data.batch_size)
    reader = DualTrainState(nets[0], nets[1], make_optimizer(
        [p for net in nets for p in net.parameters()], trainer.cfg.optim, spe, trainer.cfg.num_epochs))
    ckpt.load_train_state(path, reader)
    same = snapshots_equal(ckpt.snapshot(reader, clone=False),
                           ckpt.snapshot(trainer.state, clone=False))
    layout = sorted(written["opt_state"]["0"])
    print(f"cli_sgd: its _last_full ({os.path.getsize(path)} bytes, opt_state['0'] keys {layout}) "
          f"read back into a new pair and optimizer equal to the saved state: {same}", flush=True)
    if not same or layout != ["trace"] or not tree_equal(written, ckpt.state_tree(reader)):
        fail("cli_sgd: the sgd state did not read back")
    del trainer, reader, nets
    return first, run, sgd


# ------------------------------- phase 11 -------------------------------

SERVE_BATCHES = (1, 8, 32)

# Phase 11's serving process: it reads each artifact's container with the
# standard library and torch.export.load alone (it fails if aide_tpu_torch
# is importable), serves the card's program at SERVE_BATCHES and the host's
# at batch 1, and prints one JSON line an artifact. argv: a JSON file
# [{"name", "path", "inputs": [.npy of (32, S, S, 3)], "out": dir}, ...].
SERVE_CHILD = r"""
import importlib.util, io, json, statistics, sys, time
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

if importlib.util.find_spec("aide_tpu_torch") is not None:
    sys.exit("aide_tpu_torch is importable in the serving process")
BATCHES = %(batches)r


def read(path, platform):
    with open(path, "rb") as fh:
        if fh.read(8) != b"AIDETRC1":
            sys.exit(path + " is not a serving artifact")
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
        start, size = header["payloads"][platform]
        fh.seek(16 + n + start)
        return header, torch.export.load(io.BytesIO(fh.read(size)))


class Convs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.seen.add((str(args[0].dtype), str(args[1].dtype), args[0].device.type))
            self.count += 1
        return func(*args, **(kwargs or {}))


for art in json.load(open(sys.argv[1])):
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    header, ep = read(art["path"], "cuda")
    program = ep.module()
    torch.cuda.synchronize()
    res = {"name": art["name"], "header": header, "load_s": time.perf_counter() - t0,
           "weight_bytes": {"cuda": sum(t.numel() * t.element_size() for t in ep.state_dict.values())},
           "weight_devices": sorted({t.device.type for t in ep.state_dict.values()}),
           "autocast": [[str(a) for a in n.args[:2]] for n in ep.graph.nodes
                        if "autocast" in str(n.target).lower()]}
    host = [np.load(f) for f in art["inputs"]]
    dev = [torch.from_numpy(x).cuda() for x in host]
    res["ms"], res["images_per_s"] = {}, {}
    with torch.no_grad():
        for b in BATCHES:
            xs = [x[:b] for x in dev]
            for _ in range(3):
                out = program(*xs)
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = program(*xs)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            res["ms"][b] = statistics.median(times)
            res["images_per_s"][b] = b / res["ms"][b] * 1e3
            np.save(f"{art['out']}/{art['name']}_cuda_b{b}.npy", out.float().cpu().numpy())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        program(*dev)
        torch.cuda.synchronize()
        res["peak_b32"] = torch.cuda.max_memory_allocated()
        convs = Convs()
        with convs:
            program(*[x[:1] for x in dev])
        res["convolutions"] = [convs.count, sorted(convs.seen)]
        del program, ep, out
        t0 = time.perf_counter()
        _, ep = read(art["path"], "cpu")
        program = ep.module()
        res["cpu_load_s"] = time.perf_counter() - t0
        res["weight_bytes"]["cpu"] = sum(t.numel() * t.element_size() for t in ep.state_dict.values())
        t0 = time.perf_counter()
        out = program(*[torch.from_numpy(x[:1]) for x in host])
        res["cpu_b1_s"] = time.perf_counter() - t0
        np.save(f"{art['out']}/{art['name']}_cpu_b1.npy", out.numpy())
    del program, ep, out, dev
    print(json.dumps(res), flush=True)
""" % {"batches": SERVE_BATCHES}


def serve_inputs(name, task, cfg, work) -> list:
    """The first 32 slices of ``task``'s train manifest, normalized as the
    CLI's eval normalizes them, saved as one .npy a modality. Returns the
    files."""
    import numpy as np

    from aide_tpu_torch.data.pipeline import SlicePipeline
    from aide_tpu_torch.engine import steps

    pipe = SlicePipeline(task, task.load_manifest(cfg.data.train_csv), cfg.data.img_size,
                         cfg.data.data_mean, cfg.data.data_std)
    n = max(SERVE_BATCHES)
    if len(pipe) < n:
        fail(f"serve {name}: {len(pipe)} train slices, fewer than {n}")
    files = []
    for i, x in enumerate(steps.batch_images(pipe.batch_at(np.arange(n), images_only=True),
                                             task.two_modal)):
        files.append(os.path.join(work, f"{name}_modal{i + 1}.npy"))
        np.save(files[-1], x.float().numpy())
    return files


def eager_probs(cfg, checkpoint, files, rounded=False) -> dict:
    """{batch: softmax of the eager net (``_load_net`` on the card, its own
    autocast)}; ``rounded`` rounds every floating leaf to bf16 first."""
    import numpy as np
    import torch

    from aide_tpu_torch.cli.main import _load_net

    net = _load_net(cfg, checkpoint, "cuda")
    if rounded:
        with torch.no_grad():
            for t in net.state_dict().values():
                t.copy_(t.to(torch.bfloat16))
    xs = [torch.from_numpy(np.load(f)).cuda() for f in files]
    with torch.no_grad():
        out = {b: torch.softmax(net(*[x[:b] for x in xs]).float(), -1).cpu().numpy()
               for b in SERVE_BATCHES}
    del net, xs
    release_device_memory()
    return out


def agreement(a, b) -> tuple:
    """(share of pixels with the same argmax, mean |a - b|)."""
    import numpy as np

    return float(np.mean(a.argmax(-1) == b.argmax(-1))), float(np.abs(a - b).mean())


def run_serving(cuda_warp, scratch, chaos_export, kidney_export):
    """Phase 11: the serving export at full width. Through the CLI (``export
    --format serve``, on the card: programs for the card and the host), the
    CHAOS preset's FuseUNet-32 (phase 8 (a)'s best export of net 1) at f32
    and bf16 weights and the kidney comparison UNet-64 (phase 7 (a)'s) at
    f32; then one fresh process, which cannot import aide_tpu_torch, reads
    each container with the standard library and serves it with
    torch.export.load alone (batches 1, 8, 32 of 32 normalized slices of the
    phase 8 (a) fixture tree or of a seeded synthetic kidney case; CUDA
    events around each call, the median of 20 after 3 warm-ups; peak memory
    at 32; the host's program at batch 1). The card's program is shown to
    compute in bf16 on the card by the dtypes and devices of the
    convolutions it runs (a TorchDispatchMode over one call) and by its
    autocast region, whose device is "cuda". Each artifact must hold
    platforms cuda and cpu, sum to 1 within 1e-5, agree with the eager net
    (with bf16-rounded leaves for bf16 weights) under the same autocast on
    >= 99.9% of argmax pixels with mean |delta| <= 1e-3, and its host
    program with the card's at batch 1 on >= 99.9%; the bf16 artifact is
    under 0.75x the f32 one and within mean |delta| 5e-3 of it. An export
    for the host alone (--device cpu) must refuse the card."""
    import numpy as np

    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.data.tasks import build_task
    from aide_tpu_torch.interop.serving import load_serving_artifact

    work = fresh_dir(os.path.join(scratch, "serve"))
    release_device_memory()
    chaos_preset, kidney_preset = "chaos_proposed_30cases1labeled", "kidney_comparison_mask1"
    chaos_cfg = get_preset(chaos_preset, os.path.join(scratch, "chaos_preset", "data"))
    kidney_cfg = kidney_config(kidney_preset, scratch, "serve_kidney")
    kidney = kidney_task(scratch, "serve_kidney")
    inputs = {"chaos": serve_inputs("chaos", build_task(chaos_cfg), chaos_cfg, work),
              "kidney": serve_inputs("kidney", kidney, kidney_cfg, work)}
    arts = [("chaos_f32", chaos_preset, chaos_export, "float32", "chaos"),
            ("chaos_bf16", chaos_preset, chaos_export, "bfloat16", "chaos"),
            ("kidney_f32", kidney_preset, kidney_export, "float32", "kidney")]
    export_s = {}
    for name, preset, checkpoint, dtype, _ in arts:
        _, export_s[name] = cli_command(cuda_warp, [
            "export", "--preset", preset, "--checkpoint", checkpoint, "--output",
            f"{work}/{name}.serve", "--format", "serve", "--weights-dtype", dtype])
    # the host alone: its artifact must refuse the card, no CPU program on it
    cli_command(cuda_warp, ["export", "--preset", chaos_preset, "--checkpoint", chaos_export,
                            "--output", f"{work}/chaos_cpu_only.serve", "--format", "serve",
                            "--device", "cpu"])
    try:
        load_serving_artifact(f"{work}/chaos_cpu_only.serve", "cuda")
    except ValueError as err:
        refused = str(err)
    else:
        fail("serve: an artifact traced for the CPU alone loaded for the card")
    print(f"serve: the --device cpu export refuses the card: {refused}", flush=True)

    spec = os.path.join(work, "spec.json")
    with open(spec, "w") as fh:
        json.dump([{"name": name, "path": f"{work}/{name}.serve", "inputs": inputs[data],
                    "out": work} for name, _, _, _, data in arts], fh)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-I", "-c", SERVE_CHILD, spec], cwd=work, env=env,
                          capture_output=True, text=True, timeout=900)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve: the serving process failed ({proc.returncode}): {proc.stderr[-3000:]}")
    results = {r["name"]: r for r in map(json.loads, proc.stdout.splitlines()) if "name" in r}
    if sorted(results) != sorted(a[0] for a in arts):
        fail(f"serve: the serving process reported {sorted(results)}")

    probs = {}
    for name, preset, checkpoint, dtype, data in arts:
        r, path = results[name], f"{work}/{name}.serve"
        h = r["header"]
        cfg = chaos_cfg if data == "chaos" else kidney_cfg
        if (not {"cuda", "cpu"} <= set(h["platforms"]) or h["img_size"] != cfg.data.img_size
                or h["two_modal"] != (data == "chaos") or h["weights_dtype"] != dtype):
            fail(f"serve {name}: header {h}")
        card = {b: np.load(f"{work}/{name}_cuda_b{b}.npy") for b in SERVE_BATCHES}
        host = np.load(f"{work}/{name}_cpu_b1.npy")
        probs[name] = card
        want = eager_probs(cfg, checkpoint, inputs[data], rounded=dtype == "bfloat16")
        sums = max(float(np.abs(p.sum(-1) - 1.0).max()) for p in [*card.values(), host])
        vs_eager = {b: agreement(card[b], want[b]) for b in SERVE_BATCHES}
        vs_host = agreement(host, card[1])
        count, convs = r["convolutions"]
        print(f"serve {name}: {os.path.getsize(path)} bytes, payloads {h['payloads']}, weight "
              f"bytes {r['weight_bytes']} (on {r['weight_devices']}); export {export_s[name]:.2f} s "
              f"(CLI, both programs), load {r['load_s']:.2f} s (card), {r['cpu_load_s']:.2f} s "
              f"(host); serve ms {json.dumps(r['ms'])}, images/s "
              f"{json.dumps({b: round(v, 1) for b, v in r['images_per_s'].items()})}, peak at "
              f"batch 32 {r['peak_b32']} bytes; host program at batch 1 {r['cpu_b1_s']:.2f} s",
              flush=True)
        print(f"serve {name}: convolutions of one call {count}, (input, weight dtype, device) "
              f"{convs}; autocast regions {r['autocast']}; sums off 1 by {sums:.2e}; against the "
              f"eager net (argmax share, mean |delta|) {json.dumps(vs_eager)}; host program vs "
              f"card at batch 1 {vs_host}", flush=True)
        if (not count or convs != [["torch.bfloat16", "torch.bfloat16", "cuda"]]
                or not r["autocast"] or any(a[0] != "cuda" for a in r["autocast"])
                or r["weight_devices"] != ["cuda"]):
            fail(f"serve {name}: the card's program does not compute in bf16 on the card")
        if sums > 1e-5 or any(s < 0.999 or d > 1e-3 for s, d in vs_eager.values()) \
                or vs_host[0] < 0.999:
            fail(f"serve {name}: the served probabilities disagree")
    size16, size32 = (os.path.getsize(f"{work}/chaos_{d}.serve") for d in ("bf16", "f32"))
    bf16_vs_f32 = max(agreement(probs["chaos_bf16"][b], probs["chaos_f32"][b])[1]
                      for b in SERVE_BATCHES)
    print(f"serve: bf16 / f32 artifact bytes {size16 / size32:.4f}, mean |delta| at most "
          f"{bf16_vs_f32:.3e}; serving process {child_s:.2f} s", flush=True)
    if size16 >= 0.75 * size32 or bf16_vs_f32 >= 5e-3:
        fail("serve: the bf16 artifact is not the f32 one with rounded weights at half the size")
    return {name: {k: results[name][k] for k in ("ms", "images_per_s", "peak_b32", "load_s")}
            | {"bytes": os.path.getsize(f"{work}/{name}.serve"), "export_s": export_s[name]}
            for name, *_ in arts}


# kernel-name fragments that group the profile (first match wins)
KERNEL_KINDS = (
    ("warp_kernel", ("warp_rotate_flip",)),
    ("nccl", ("nccl",)),
    ("conv", ("xmma", "implicit_gemm", "conv", "cudnn", "wgrad", "dgrad", "gemm", "cutlass")),
    ("batch_norm", ("batch_norm",)),
    ("upsample", ("upsample",)),
    ("max_pool", ("max_pool",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("copy_cast_cat", ("copy", "CatArray", "Memcpy", "Memset")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


@contextlib.contextmanager
def tagged_halos():
    """Inside, each halo exchange of ``core.mesh`` (its all-gather, in the
    forward and the backward) runs in a ``record_function("halo_exchange")``
    range, so that a trace attributes its NCCL kernels to it."""
    from torch.profiler import record_function

    from aide_tpu_torch.core import mesh

    gather_space = mesh._gather_space

    def tagged(x, kind):
        if kind != "halo":
            return gather_space(x, kind)
        with record_function("halo_exchange"):
            return gather_space(x, kind)

    mesh._gather_space = tagged
    try:
        yield
    finally:
        mesh._gather_space = gather_space


def device_breakdown(prof, steps: int, wall_us: float) -> dict:
    """A step's device time from a torch.profiler trace of ``steps`` steps
    taken in ``wall_us`` of host time: busy and idle share, launches, ms by
    kernel kind and the top kernels, and the halo exchanges' device time
    (inside ``tagged_halos``: the kernels CUPTI correlates with the
    ranges, their NCCL all-gathers with the waits for the peer in them)."""
    from torch.autograd import DeviceType

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
    ranges = [e for e in prof.events()
              if e.name == "halo_exchange" and e.device_type == DeviceType.CPU]
    halo_us = sum(e.device_time_total if hasattr(e, "device_time_total") else e.cuda_time_total
                  for e in ranges)
    return {
        "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if wall_us > 0 else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "kinds_ms_per_step": {k: t / steps / 1e3
                              for k, t in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[n[:90], t / steps / 1e3] for n, t in top],
        "halo_exchanges_per_step": len(ranges) / steps,
        "halo_ms_per_step": halo_us / steps / 1e3,
    }


def profile_steps(name, trainer, steps: int = 3) -> dict:
    """With --profile: device time by kernel over a few more co-teaching
    steps of ``trainer``, the device's busy share of the host wall time
    around them and the halo exchanges' device time (torch.profiler,
    CUPTI; ``device_breakdown``). On a data axis every rank steps (the
    collectives need them all) on its rows and gets the breakdown of its
    own trace; rank 0 prints."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aide_tpu_torch.core import mesh

    b = trainer.cfg.data.batch_size
    batch = trainer._on_device(next(trainer.train_pipe.batches(b, rng=np.random.default_rng(0))))
    degrees, hflip = trainer.view_params(0, 0, b)
    rows = mesh.local_rows(b)
    args = (trainer.state, batch, degrees[:, rows], hflip[:, rows], 0.5,
            *trainer._flags(mesh.rows_sharded(b), mesh.h_sharded(b)))
    trainer.train_step(*args)
    torch.cuda.synchronize()
    with tagged_halos(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_breakdown(prof, steps, wall_us)
    if mesh.is_primary():
        print(f"profile ({name}): " + json.dumps(out), flush=True)
    return out


def small_config(model: str = "fuseunet", supervised: bool = False, options=None):
    """Phase 6's slice: 32 px, base width 4, f32, both epochs refreshing
    (dual), or the supervised comparison trainer; ``options`` sets model
    fields (phase 9's learned upsample and GroupNorm)."""
    from aide_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig()
    cfg.model.name = model
    cfg.model.base_width = 4
    cfg.model.compute_dtype = "float32"
    for key, value in (options or {}).items():
        setattr(cfg.model, key, value)
    cfg.data.task = "synthetic"
    cfg.data.img_size = 32
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 3
    cfg.data.num_tta_views = 2
    cfg.coteach.warmup_epochs = 3  # both epochs refresh
    cfg.mesh.num_devices = 1  # one card (chaos_config)
    if supervised:
        cfg.data.variant = "comparison"
        cfg.coteach.enabled = False
    # AMSGrad's first steps move each parameter by about lr along its
    # gradient's sign, which rounding decides for near-zero gradients; at
    # lr 1e-4 that alone moves the thresholded dice sums by up to ~5e-3
    # between two runs, at 1e-6 by ~1e-6 (tests/test_torch_trainer.py)
    cfg.optim.lr = 1e-6
    return cfg


def small_run(cfg, device, cache, weights, scratch, two_modal=True) -> dict:
    """Two epochs of run_epoch on phase 6's slice from ``weights`` (None:
    the trainer's own initialisation or warm start). Returns the rows, the
    refresh log, the working labels, each refresh's case dice {(epoch, net):
    {case: dice}}, the worst-k count, the initial weights, the best epochs
    and the best export of the last net."""
    import numpy as np
    import torch

    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine.trainer import Trainer

    name = f"small_{cfg.model.name}_{cfg.data.variant}_{device}_{cache}"
    root = fresh_dir(os.path.join(scratch, name))
    cfg.checkpoint_dir = os.path.join(root, "ckpt")
    cfg.history_dir = os.path.join(root, "hist")
    cfg.data.device_cache = cache
    # 4 train cases, so that int(0.25 * 4) = 1 case a net is refreshed
    task = SyntheticTask(
        root=root, tempmask_folder="tempmasks", two_modal=two_modal, num_cases=4,
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
    case_dice, best = {}, []
    inner_refresh, inner_gate = tr._refresh_labels, tr._maybe_checkpoint

    def refresh(epoch, traincase):
        for n in traincase:
            case_dice[epoch, n] = {r.case_id: r.dice for r in traincase[n]}
        inner_refresh(epoch, traincase)

    def gate(epoch, *args, **kw):
        saved = inner_gate(epoch, *args, **kw)
        if saved:
            best.append(epoch + 1)
        return saved

    tr._refresh_labels, tr._maybe_checkpoint = refresh, gate
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
    tr.flush_checkpoints()
    if tr.dual:
        # host batches take the unfused branch, device-resident data the fused one
        took = all(calls.values()) if cache == "off" else not any(calls.values())
    else:
        # the supervised test pass is always the separate one; predictions
        # go per batch only from host batches
        took = calls["_test_epoch"] > 0 and (calls["predict_step"] > 0) == (cache == "off")
    if not took:
        fail(f"{name}: the run did not take its branch: {calls}")
    print(f"small slice {cfg.model.name} {cfg.data.variant} on {device}, device_cache {cache!r}: "
          f"unfused-branch calls {calls}, best epochs {best}", flush=True)
    k = int(cfg.coteach.update_percent * len(tr.train_cases))
    labels = [tr.train_pipe.labels.get(n) for n in (1, 2)] if tr.dual else []
    export = ckpt.best_net_path(cfg.checkpoint_dir, cfg.experiment_name,
                                len(tr.state.nets) if tr.dual else None)
    return dict(rows=rows, log=tr.refresh_log, labels=labels, case_dice=case_dice, k=k,
                weights=weights, best=best, export=export)


def boundary_gaps(case_dice, k):
    """{(epoch, net): the dice gap between the k-th and (k+1)-th worst case}."""
    gaps = {}
    for key, d in case_dice.items():
        ranked = sorted(d.values())
        gaps[key] = ranked[k] - ranked[k - 1]
    return gaps


def worst_difference(gpu_rows, cpu_rows) -> float:
    """The largest difference of a history metric between two runs,
    relative above 1 and absolute below (thresholded dice sums can sit near
    0)."""
    worst = 0.0
    for g, c in zip(gpu_rows, cpu_rows):
        for key, v in c.items():
            if not key.startswith("time"):
                worst = max(worst, abs(g[key] - v) / max(abs(v), 1.0))
    return worst


def small_dual_vs_cpu(scratch, model="fuseunet", two_modal=True, resume="", options=None,
                      caches=("auto", "off")):
    """Phase 6, dual: two epochs of run_epoch at 32 px, with refresh, f32,
    from the same weights and view parameters: on the card with the data on
    the device (the fused test pass, whole-set prediction) and with host
    batches (device_cache "off": the separate test pass, per-batch
    prediction), each against the CPU. ``resume`` warm-starts the pair from
    an export; the card runs take the CPU run's warm-started weights.

    The refresh comparison means something only where the CPU run's worst-k
    boundary is not a tie (a net that predicts no foreground scores several
    cases 0). So the CPU runs first, from seeds 0, 1, ... (initialisation or
    warm-start noise), until every refresh has a gap at that boundary; which
    seed gives one depends on the torch build. Then each card run must
    repeat the CPU's decisions, and each gap must exceed the largest card-CPU
    case-dice difference. ``options`` sets model fields; ``caches`` are the
    card runs' device_cache settings."""
    from aide_tpu_torch.evaluation.case_eval import dice3d_np

    cfg = small_config(model, options=options)
    model = f"{model} {json.dumps(options)}" if options else model
    cfg.resume_file = resume
    for seed in range(10):
        cfg.seed = seed
        cpu = small_run(cfg, "cpu", "auto", None, scratch, two_modal)
        gaps = boundary_gaps(cpu["case_dice"], cpu["k"])
        print(f"small slice {model}, CPU, seed {seed}: worst-{cpu['k']} boundary gaps "
              + json.dumps(sorted(gaps.items())), flush=True)
        if len(gaps) == len(cpu["log"]) and min(gaps.values()) > 0.0:
            break
    else:
        fail(f"{model}: no seed in 0-9 gives the CPU run a refresh without a tie")
    for cache in caches:
        gpu = small_run(cfg, "cuda", cache, cpu["weights"], scratch, two_modal)
        name = f"small slice {model}{' warm-started' if resume else ''}, card (device_cache {cache!r}) vs CPU"
        if gpu["log"] != cpu["log"]:
            fail(f"{name}: refresh decisions differ: card {gpu['log']}, CPU {cpu['log']}")
        agreement = [dice3d_np(g, c) for g, c in zip(gpu["labels"], cpu["labels"])]
        worst = worst_difference(gpu["rows"], cpu["rows"])
        margins = [(gaps[key], max(abs(gpu["case_dice"][key][c] - d)
                                   for c, d in cpu["case_dice"][key].items()))
                   for key in sorted(cpu["case_dice"])]
        print(f"{name}: refresh margins (CPU gap at the worst-{cpu['k']} boundary, largest "
              f"card-CPU case-dice difference): " + json.dumps(margins), flush=True)
        print(f"{name}: refresh decisions identical {gpu['log']}; working-label agreement "
              f"{agreement[0]:.6f}/{agreement[1]:.6f}; worst metric difference {worst:.3e} "
              f"(relative above 1, absolute below)", flush=True)
        if not all(gap > diff for gap, diff in margins):
            fail(f"{name}: a refresh decision has no margin: {margins}")
        if min(agreement) < 0.995:
            fail(f"{name}: working labels agree only to Dice {agreement}")
        if worst > 1e-3:
            fail(f"{name}: metrics disagree: {gpu['rows']} vs {cpu['rows']}")


def small_supervised_vs_cpu(scratch, model="unet", two_modal=False) -> str:
    """Phase 6, supervised: two epochs of the comparison trainer at 32 px,
    f32, from the same weights, on the card (device-resident and host
    batches) against the CPU: history within 1e-3 (relative above 1,
    absolute below), the same best epochs. Returns the CPU run's best
    export."""
    cfg = small_config(model, supervised=True)
    cpu = small_run(cfg, "cpu", "auto", None, scratch, two_modal)
    for cache in ("auto", "off"):
        gpu = small_run(cfg, "cuda", cache, cpu["weights"], scratch, two_modal)
        name = f"small slice {model} supervised, card (device_cache {cache!r}) vs CPU"
        worst = worst_difference(gpu["rows"], cpu["rows"])
        print(f"{name}: best epochs {gpu['best']} / {cpu['best']}; worst metric difference "
              f"{worst:.3e} (relative above 1, absolute below)", flush=True)
        if gpu["best"] != cpu["best"] or worst > 1e-3:
            fail(f"{name}: runs disagree: {gpu['rows']} vs {cpu['rows']}")
    if not cpu["best"]:
        fail(f"{model}: the supervised CPU run logged no best epoch to warm-start from")
    return cpu["export"]

# ------------------------------- phase 12 -------------------------------


def digest(arrays) -> str:
    """sha1 over the bytes of a sequence of tensors or arrays."""
    import hashlib

    h = hashlib.sha1()
    for a in arrays:
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else a
        h.update(a.tobytes())
    return h.hexdigest()


def global_batchnorm_error(rank, world, batch, device):
    """The train-mode BatchNorm's fused path (torch's per-channel kernels;
    over more than one rank an all-gather forward and an all-reduce
    backward) on this rank's rows of a seeded global batch at the first
    norm's shape, FuseUNet-32 at 256 px, held to F.batch_norm of the whole
    batch on this card: the largest absolute error of y, dx and the summed
    dweight and dbias, each over its reference's largest magnitude. Run
    directly, so a world of one runs it too."""
    import torch
    import torch.nn.functional as F

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.models import blocks

    gen = torch.Generator().manual_seed(12)
    x_all, g_all = (torch.randn(batch, 32, 256, 256, generator=gen) * 2 + 0.5 for _ in range(2))
    w0, b0 = torch.randn(32, generator=gen), torch.randn(32, generator=gen)
    rows = slice(rank * batch // world, (rank + 1) * batch // world)

    def on_card(t):
        t = t.to(device, copy=True)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    x, w, b = (on_card(t).requires_grad_() for t in (x_all[rows], w0, b0))
    y, _, _ = blocks._BatchNormTrain.apply(x, w, b, 1e-5, *mesh.replicas(False))
    (y * on_card(g_all[rows])).sum().backward()
    grads = torch.cat([w.grad, b.grad])
    mesh.all_reduce(grads)
    xr, wr, br = (on_card(t).requires_grad_() for t in (x_all, w0, b0))
    yr = F.batch_norm(xr, None, None, wr, br, True, 0.0, 1e-5)
    (yr * on_card(g_all)).sum().backward()
    torch.cuda.synchronize()
    pairs = ((y, yr[rows]), (x.grad, xr.grad[rows]), (grads[:32], wr.grad), (grads[32:], br.grad))
    return max(float((got - ref).abs().max() / ref.abs().max()) for got, ref in
               ((got.detach(), ref.detach()) for got, ref in pairs))


def rank_label_checks(trainer, task, rank):
    """(the working labels, whether this rank's device copy of them equals
    the host's rows, whether rank 0's tempmasks read back as them)."""
    import numpy as np

    pipe = trainer.train_pipe
    labels = [pipe.labels.get(n) for n in (1, 2)]
    # each rank's device block of the working labels equals the host's rows
    blocks_ok = True
    if pipe._sharded is not None:
        c = pipe._sharded
        rows = np.clip(np.arange(c.lo, c.lo + c.shard), 0, len(pipe) - 1)
        blocks_ok = all(np.array_equal(c.rows(f"target{n}").cpu().numpy(), labels[n - 1][rows])
                        for n in (1, 2))
    elif pipe._device_labels is not None:
        blocks_ok = all(np.array_equal(pipe._device_labels[f"target{n}"].cpu().numpy(),
                                       labels[n - 1]) for n in (1, 2))
    # the primary's tempmasks read back as the labels it holds
    tempmasks_ok = True
    if rank == 0:
        for _, net, _, rewritten in trainer.refresh_log:
            for case in rewritten:
                for i in pipe.case_indices(case):
                    disk = task.read_tempmask(pipe.specs[i], net)
                    tempmasks_ok &= disk is not None and np.array_equal(disk, labels[net - 1][i])
    return labels, blocks_ok, tempmasks_ok


def warp_vs_plain(launches, rank, device) -> float:
    """The warp at a rank's launch shapes ((images, C, inverse) at 256 px,
    ±60 degrees), against its plain version on the rank's card: the
    largest absolute difference."""
    import torch

    from aide_tpu_torch.ops import cuda_warp

    worst = 0.0
    for n_img, c, inverse in launches:
        degrees = [60.0 * (2.0 * i / (n_img - 1) - 1.0) for i in range(n_img)]
        images, degrees_t, hflip_t, fill = warp_inputs(degrees, [i % 2 for i in range(n_img)], 256,
                                                       c, seed=rank + c, device=device)
        table = cuda_warp.coef_table(degrees_t, hflip_t, inverse)
        got = cuda_warp.warp_rotate_flip(images, degrees_t, hflip_t, fill, inverse=inverse)
        ref = cuda_warp.warp_plain(images, table, cuda_warp.fill_table(fill, n_img, c, device),
                                   inverse)
        torch.cuda.synchronize()
        worst = max(worst, float((got - ref).abs().max()))
    return worst


def data_axis_rank(rank, device, scratch, world, profile=False):
    """Phase 12 on one rank (a process of ``mesh.launch``, on its card):
    phase 5's CHAOS point, Trainer.run(2) with this rank's rows, driven as
    phase 5's; its own files under ``scratch/rank{rank}``. Returns what the
    phase compares across ranks and with phase 5. A failed check exits this
    rank non-zero, which ends the launch."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.trainer import Trainer
    from aide_tpu_torch.ops import cuda_warp

    work = fresh_dir(os.path.join(scratch, f"rank{rank}"))
    cfg = chaos_config()
    cfg.mesh.num_devices = world
    cfg.checkpoint_dir = os.path.join(work, "ckpt")
    cfg.history_dir = os.path.join(work, "hist")
    cfg.data.tempmask_folder = "tempmasks"
    task = chaos_task(os.path.join(work, "chaos"))
    release_device_memory()
    trainer = Trainer(cfg, task, device=device)
    trainer.label_cases = set(task.clean_case_ids())
    if trainer.world != world or trainer.device != device:
        fail(f"rank {rank}: trainer on {trainer.device} at world {trainer.world}")
    per_step, inner = [], trainer.train_step

    def counted(*args):
        before = mesh.collectives
        out = inner(*args)
        per_step.append(mesh.collectives - before)
        return out

    trainer.train_step = counted
    mesh.reset_collectives()
    run = drive(trainer, cuda_warp)
    trainer.train_step = inner
    if profile:
        profile_steps(f"data axis, world {world}", trainer)
    labels, blocks_ok, tempmasks_ok = rank_label_checks(trainer, task, rank)
    v, b = cfg.data.num_tta_views, cfg.data.batch_size // world
    warp_err = warp_vs_plain(((v * b, 3, False), (2 * v * b, 2, True)), rank, device)
    bn_err = global_batchnorm_error(rank, world, cfg.data.batch_size, device)
    # the gradient all-reduce: the flat buffer of the pair's gradients (the
    # step's last ones), summed over the ranks
    params = trainer.state.optimizer.params()
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    allreduce_ms = time_cuda(lambda: mesh.all_reduce(flat), runs=20, warmup=3)
    sync_ms = time_cuda(lambda: mesh.all_reduce_grads(params), runs=20, warmup=3)
    state = [t for net in trainer.state.nets for _, t in sorted(net.state_dict().items())]
    return dict(
        rank=rank, device=str(device), world=mesh.world_size(), name=torch.cuda.get_device_name(device),
        rows=run["rows"], case_dice=run["case_dice"], refresh_log=list(trainer.refresh_log),
        steady=run["steady"], step_ms=run["step_ms"], spe=run["spe"], peak=run["peak"],
        launches=run["launches"], outside=run["outside"], best_epochs=run["best_epochs"],
        step_launches=run["step_launches"], replayed=run["replayed"], replays=run["replays"],
        step_upsample=run["step_upsample"], upsample_per_step=run["upsample_per_step"],
        collectives_per_step=per_step, state=digest(state), labels=digest(labels),
        blocks_ok=blocks_ok, tempmasks_ok=tempmasks_ok, warp_err=warp_err, bn_err=bn_err,
        allreduce_ms=allreduce_ms, allreduce_bytes=flat.numel() * 4, sync_ms=sync_ms,
        files=sorted(os.path.relpath(os.path.join(d, f), work)
                     for d, _, fs in os.walk(work) for f in fs if "tempmasks" in d or
                     d.endswith(("ckpt", "hist"))),
    )


def run_data_axis(scratch, chaos, chaos_log, profile=False):
    """Phase 12: phase 5's CHAOS point through ``mesh.launch`` on a data
    axis of N = fit_data_devices(8, min(cards, 4)) NCCL ranks, one process
    a card (on one card: one rank in this process over a real NCCL group
    of one, said so). Holds rank 0's history to phase 5's (dice 0.03
    absolute, losses rtol 2e-2 and atol 2e-3, the epochs equal: the JAX
    package's cross-mesh bars), each refresh decision to phase 5's with a
    margin, every rank to the same parameters, BN statistics and working
    labels, the files to rank 0 alone, and the warp at the per-rank shapes
    to its plain version."""
    import torch

    from aide_tpu_torch.core import mesh

    cards = torch.cuda.device_count()
    world = mesh.fit_data_devices(8, min(cards, 4))
    cfg = chaos_config()
    cfg.mesh.num_devices = world
    if world == 1:
        # launch runs the one rank here; the job of one joins NCCL all the same
        cfg.mesh.coordinator_address = f"127.0.0.1:{mesh.free_port()}"
        cfg.mesh.num_processes, cfg.mesh.process_id = 1, 0
    work = fresh_dir(os.path.join(scratch, "data_axis"))
    release_device_memory()
    t0 = time.perf_counter()
    try:
        ranks = mesh.launch(data_axis_rank, cfg, "cuda", (work, world, profile))
    except Exception as err:  # a rank that failed ends the launch
        fail(f"phase 12: the data axis of {world} rank(s) failed: {err}")
    seconds = time.perf_counter() - t0
    if sorted(ranks) != list(range(world)) or any(r["world"] != world for r in ranks.values()):
        fail(f"phase 12: ranks {sorted(ranks)} of worlds {[r['world'] for r in ranks.values()]}")
    r0 = ranks[0]
    print(f"data axis: world {world} over NCCL, {cards} card(s) visible, "
          + ("more than one rank ran" if world > 1 else
             "one rank over a real NCCL group: more than one rank was not exercised on this "
             "machine (the CPU tests over gloo cover two)")
          + f"; devices {[ranks[r]['device'] for r in sorted(ranks)]}; {seconds:.1f} s", flush=True)
    for r in sorted(ranks):
        print(f"data axis rank {r} ({ranks[r]['device']}, {ranks[r]['name']}): median step "
              f"{ranks[r]['steady']:.3f} ms, max_memory_allocated {ranks[r]['peak']} bytes, warp "
              f"launches {ranks[r]['launches']} ({ranks[r]['outside']} outside the train steps), "
              f"collectives a step {sorted(set(ranks[r]['collectives_per_step']))}, warp vs plain "
              f"at the rank's shapes max abs {ranks[r]['warp_err']:.3e}; global BatchNorm "
              f"(fused kernels, rows of a seeded batch of 8 at (32, 256, 256) f32) vs "
              f"F.batch_norm of the whole batch: y, dx, dweight, dbias max abs over the "
              f"reference's largest {ranks[r]['bn_err']:.3e} (bound 1e-4)", flush=True)
    print_run("data_axis", r0)
    print(f"data axis: median step at world {world} {r0['steady']:.3f} ms, at world 1 (phase 5) "
          f"{chaos['steady']:.3f} ms; gradient all-reduce {r0['allreduce_bytes']} bytes: "
          f"{r0['allreduce_ms']:.4f} ms the collective, {r0['sync_ms']:.4f} ms the step's "
          f"all_reduce_grads with its flatten and copy back (CUDA events, median of 20)"
          + ("; at world 1 the step calls no collective (all_reduce_grads returns at once) and "
             "the all-reduce is NCCL's over a group of one" if world == 1 else ""), flush=True)
    def metrics(res):
        return [{k: v for k, v in row.items() if not k.startswith("time")} for row in res["rows"]]

    for r in sorted(ranks)[1:]:
        other = ranks[r]
        if (other["state"], other["labels"], other["refresh_log"], metrics(other)) != (
                r0["state"], r0["labels"], r0["refresh_log"], metrics(r0)):
            fail(f"phase 12: rank {r} ends with other parameters, labels or history than rank 0")
        if other["files"]:
            fail(f"phase 12: rank {r} wrote files: {other['files'][:5]}")
    for r, res in ranks.items():
        if launch_fault(res, 3):
            fail(f"phase 12: rank {r}: {launch_fault(res, 3)}")
        if (not (res["blocks_ok"] and res["tempmasks_ok"]) or res["warp_err"] > 1e-5
                or not res["bn_err"] <= 1e-4):
            fail(f"phase 12: rank {r}: device labels {res['blocks_ok']}, tempmasks "
                 f"{res['tempmasks_ok']}, warp max abs {res['warp_err']}, global BatchNorm "
                 f"relative error {res['bn_err']}")
    wanted = ("_history.json", ".log", "_last_full.msgpack", "_besttraincasedice.pkl", ".png")
    if not all(any(f.endswith(w) for f in r0["files"]) for w in wanted):
        fail(f"phase 12: rank 0 did not write every file: {r0['files']}")
    hold_to_phase5("phase 12", "data axis", f"world {world}", r0, chaos, chaos_log)
    return dict(r0, ranks=ranks, seconds=seconds, cards=cards)


def hold_to_phase5(phase, name, layout, r0, chaos, chaos_log) -> None:
    """Rank 0's history of a multi-rank run held to phase 5's with the JAX
    package's cross-mesh bars (dice within 0.03, losses within rtol 2e-2
    and atol 2e-3, the other keys equal), and its refresh decisions to
    phase 5's, each with a margin: phase 5's case-dice gap at the worst-1
    boundary above the largest difference of a case's dice."""
    for want, got in zip(chaos["rows"], r0["rows"]):
        for key, v in want.items():
            if key.startswith("time"):
                continue
            ok = (abs(got[key] - v) < 0.03 if "dice" in key else
                  math.isclose(got[key], v, rel_tol=2e-2, abs_tol=2e-3) if "loss" in key else
                  got[key] == v)
            if not ok:
                fail(f"{phase}: epoch {want['epoch']} {key}: {layout} {got[key]}, world 1 {v}")
    log5 = [tuple(entry[:3]) for entry in chaos_log]
    log = [tuple(entry[:3]) for entry in r0["refresh_log"]]
    gaps = boundary_gaps(chaos["case_dice"], 1)
    margins = [(gaps[key], max(abs(r0["case_dice"][key][c] - d)
                               for c, d in chaos["case_dice"][key].items()))
               for key in sorted(chaos["case_dice"])]
    print(f"{name}: refresh decisions {log} (phase 5: {log5}); margins (phase 5's gap at "
          f"the worst-1 boundary, largest {layout} vs world-1 case-dice difference): "
          + json.dumps(margins) + f"; worst metric difference "
          f"{worst_difference(r0['rows'], chaos['rows']):.3e} (relative above 1, absolute "
          f"below)", flush=True)
    if log != log5 or not all(gap > diff for gap, diff in margins):
        fail(f"{phase}: refresh decisions {log} against phase 5's {log5}, margins {margins}")


# ------------------------------- phase 13 -------------------------------


def net_axis_config(world: int):
    """Phase 5's CHAOS point with a net axis of 2 over ``world`` cards (0:
    every visible card): data world/2 x net 2."""
    cfg = chaos_config()
    cfg.mesh.num_devices = world
    cfg.mesh.extra_axes = (("net", 2),)
    return cfg


def net_axis_rank(rank, device, scratch, world, profile=False):
    """Phase 13 on one rank (a process of ``mesh.launch``, on its card):
    phase 5's CHAOS point, Trainer.run(2) with net rank % 2 of the pair on
    data shard rank // 2's rows, driven as phase 5's; its own files under
    ``scratch/rank{rank}``. Returns what the phase compares across ranks
    and with phase 5. A failed check exits this rank non-zero, which ends
    the launch."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.state import NetRankState
    from aide_tpu_torch.engine.trainer import Trainer
    from aide_tpu_torch.ops import cuda_warp

    work = fresh_dir(os.path.join(scratch, f"rank{rank}"))
    cfg = net_axis_config(world)
    cfg.checkpoint_dir = os.path.join(work, "ckpt")
    cfg.history_dir = os.path.join(work, "hist")
    cfg.data.tempmask_folder = "tempmasks"
    task = chaos_task(os.path.join(work, "chaos"))
    release_device_memory()
    trainer = Trainer(cfg, task, device=device)
    trainer.label_cases = set(task.clean_case_ids())
    state = trainer.state
    if (trainer.world != world or trainer.device != device or not isinstance(state, NetRankState)
            or state.index != rank % 2):
        fail(f"rank {rank}: trainer on {trainer.device} at world {trainer.world} holds "
             f"{type(state).__name__} {getattr(state, 'index', None)}")
    per_step, bytes_per_step, inner = [], [], trainer.train_step

    def counted(*args):
        before, before_bytes = mesh.collectives, mesh.collective_bytes
        out = inner(*args)
        per_step.append(mesh.collectives - before)
        bytes_per_step.append(mesh.collective_bytes - before_bytes)
        return out

    trainer.train_step = counted
    mesh.reset_collectives()
    run = drive(trainer, cuda_warp)
    trainer.train_step = inner
    # the net as the run ended (and _last_full holds it), before any profiled step
    net_state = digest([t for _, t in sorted(state.net.state_dict().items())])
    if profile:
        profile_steps(f"net axis, world {world}", trainer)
    labels, blocks_ok, tempmasks_ok = rank_label_checks(trainer, task, rank)
    data = world // 2
    v, b = cfg.data.num_tta_views, cfg.data.batch_size // data
    warp_err = warp_vs_plain(((v * b, 3, False), (v * b, 2, True)), rank, device)
    # the step's pair exchange at its shapes: the per-image losses, the
    # pseudo-labels and weight map of the data group's rows, the dice sum
    rows = cfg.data.batch_size
    gen = torch.Generator(device=device).manual_seed(rank)
    sent = (torch.rand(rows, device=device, generator=gen),
            torch.rand((rows, 256, 256, 3), device=device, generator=gen),
            torch.rand((), device=device, generator=gen))
    exchange_bytes = sum(t.numel() * t.element_size() for t in sent)
    exchange_ms = time_cuda(lambda: mesh.pair_exchange(*sent), runs=20, warmup=3)
    allreduce = {}
    if data > 1:
        # the gradient all-reduce of this rank's net over its data group
        params = state.optimizer.params()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        allreduce = dict(allreduce_bytes=flat.numel() * 4,
                         allreduce_ms=time_cuda(lambda: mesh.all_reduce(flat), runs=20, warmup=3),
                         sync_ms=time_cuda(lambda: mesh.all_reduce_grads(params), runs=20,
                                           warmup=3))
    return dict(
        rank=rank, device=str(device), world=mesh.world_size(), net_size=mesh.net_size(),
        index=state.index, name=torch.cuda.get_device_name(device),
        rows=run["rows"], case_dice=run["case_dice"], refresh_log=list(trainer.refresh_log),
        steady=run["steady"], step_ms=run["step_ms"], spe=run["spe"], peak=run["peak"],
        launches=run["launches"], outside=run["outside"], best_epochs=run["best_epochs"],
        step_launches=run["step_launches"], replayed=run["replayed"], replays=run["replays"],
        step_upsample=run["step_upsample"], upsample_per_step=run["upsample_per_step"],
        collectives_per_step=per_step, collective_bytes_per_step=bytes_per_step,
        state=net_state, labels=digest(labels), blocks_ok=blocks_ok,
        tempmasks_ok=tempmasks_ok, warp_err=warp_err, exchange_bytes=exchange_bytes,
        exchange_ms=exchange_ms, **allreduce,
        files=sorted(os.path.relpath(os.path.join(d, f), work)
                     for d, _, fs in os.walk(work) for f in fs if "tempmasks" in d or
                     d.endswith(("ckpt", "hist"))),
    )


def run_net_layout(scratch, world, chaos, chaos_log, data_axis, profile=False):
    """Phase 13 at one layout: phase 5's CHAOS point through ``mesh.launch``
    on ``world`` cards, data world/2 x net 2. Holds rank 0's history and
    refresh decisions to phase 5's (``hold_to_phase5``), the ranks of each
    net to equal parameters and BN statistics, every rank to the same
    history and working labels (host and device), the files to rank 0
    alone, 3 warp launches a step on every rank, the warp at the per-rank
    shapes to its plain version, and rank 0's ``_last_full`` to the ranks'
    nets through a one-process Trainer resumed from it."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine.trainer import Trainer

    name = f"net axis {world // 2}x2"
    work = fresh_dir(os.path.join(scratch, f"net_axis_{world}"))
    release_device_memory()
    t0 = time.perf_counter()
    try:
        ranks = mesh.launch(net_axis_rank, net_axis_config(world), "cuda", (work, world, profile))
    except Exception as err:  # a rank that failed ends the launch
        fail(f"phase 13: the net axis on {world} cards failed: {err}")
    seconds = time.perf_counter() - t0
    if sorted(ranks) != list(range(world)) or any(
            (r["world"], r["net_size"], r["index"]) != (world, 2, i % 2) for i, r in ranks.items()):
        fail(f"phase 13: ranks {sorted(ranks)}: "
             f"{[(r['world'], r['net_size'], r['index']) for r in ranks.values()]}")
    r0 = ranks[0]
    print(f"{name}: world {world} over NCCL, net_size 2, data {world // 2}, "
          f"{torch.cuda.device_count()} cards visible; devices "
          f"{[ranks[r]['device'] for r in sorted(ranks)]}; {seconds:.1f} s", flush=True)
    for r in sorted(ranks):
        res = ranks[r]
        print(f"{name} rank {r} ({res['device']}, {res['name']}, net {res['index'] + 1}): median "
              f"step {res['steady']:.3f} ms, max_memory_allocated {res['peak']} bytes, warp "
              f"launches {res['launches']} ({res['outside']} outside the train steps), "
              f"collectives a step {sorted(set(res['collectives_per_step']))} of "
              f"{sorted(set(res['collective_bytes_per_step']))} bytes, warp vs plain at the "
              f"rank's shapes max abs {res['warp_err']:.3e}; pair exchange "
              f"{res['exchange_bytes']} bytes a rank {res['exchange_ms']:.4f} ms"
              + (f"; gradient all-reduce {res['allreduce_bytes']} bytes {res['allreduce_ms']:.4f} "
                 f"ms, all_reduce_grads {res['sync_ms']:.4f} ms" if "allreduce_ms" in res else "")
              + " (CUDA events, median of 20)", flush=True)
    print_run(name.replace(" ", "_"), r0)
    print(f"{name}: median step {r0['steady']:.3f} ms (ranks "
          f"{[round(ranks[r]['steady'], 3) for r in sorted(ranks)]}), phase 5 (one card) "
          f"{chaos['steady']:.3f} ms, phase 12 (data axis of {data_axis['world']}) "
          f"{data_axis['steady']:.3f} ms", flush=True)

    def metrics(res):
        return [{k: v for k, v in row.items() if not k.startswith("time")} for row in res["rows"]]

    for r in sorted(ranks)[1:]:
        other = ranks[r]
        if (other["labels"], other["refresh_log"], metrics(other)) != (
                r0["labels"], r0["refresh_log"], metrics(r0)):
            fail(f"phase 13: rank {r} ends with other labels or history than rank 0")
        if other["state"] != ranks[r % 2]["state"]:
            fail(f"phase 13: rank {r} ends with other parameters than rank {r % 2} (net "
                 f"{r % 2 + 1})")
        if other["files"]:
            fail(f"phase 13: rank {r} wrote files: {other['files'][:5]}")
    for r, res in ranks.items():
        if launch_fault(res, 3):
            fail(f"phase 13: rank {r}: {launch_fault(res, 3)}")
        if not (res["blocks_ok"] and res["tempmasks_ok"]) or res["warp_err"] > 1e-5:
            fail(f"phase 13: rank {r}: device labels {res['blocks_ok']}, tempmasks "
                 f"{res['tempmasks_ok']}, warp max abs {res['warp_err']}")
    wanted = ("_history.json", ".log", "_last_full.msgpack", "_net1_besttraincasedice.pkl",
              "_net2_besttraincasedice.pkl", ".png")
    if not all(any(f.endswith(w) for f in r0["files"]) for w in wanted):
        fail(f"phase 13: rank 0 did not write every file: {r0['files']}")
    hold_to_phase5("phase 13", name, name, r0, chaos, chaos_log)
    # rank 0's _last_full holds the pair: a one-process trainer resumes it
    cfg = chaos_config()
    cfg.resume_file = ckpt.full_path(os.path.join(work, "rank0", "ckpt"), cfg.experiment_name,
                                     last=True)
    cfg.checkpoint_dir = fresh_dir(os.path.join(work, "resume", "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(work, "resume", "hist"))
    resumed = Trainer(cfg, chaos_task(os.path.join(work, "rank0", "chaos")))
    got = [digest([t for _, t in sorted(net.state_dict().items())]) for net in resumed.state.nets]
    if got != [ranks[0]["state"], ranks[1]["state"]] or resumed.start_epoch != 2:
        fail(f"phase 13: rank 0's _last_full does not hold the ranks' nets ({got} against "
             f"{[ranks[0]['state'], ranks[1]['state']]}, next epoch {resumed.start_epoch})")
    print(f"{name}: rank 0's _last_full ({os.path.getsize(cfg.resume_file)} bytes) resumes in "
          f"one process at epoch {resumed.start_epoch + 1} with the pair equal to ranks 0 and "
          f"1's nets bit for bit", flush=True)
    del resumed
    release_device_memory()
    return dict(r0, ranks=ranks, seconds=seconds)


def run_net_axis(scratch, chaos, chaos_log, data_axis, profile=False):
    """Phase 13: the net axis on the cards of this machine: net 2 at data 1
    on 2 cards and, with 4, data 2 x net 2 (``run_net_layout``). With one
    card, a net axis must raise naming the cards; that is what the phase
    checks there, and it says that the axis was not exercised. Returns
    {world: run}."""
    import torch

    from aide_tpu_torch.core import mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        try:
            mesh.launch(net_axis_rank, net_axis_config(0), "cuda", (scratch, 2, profile))
        except ValueError as err:
            if "card" not in str(err):
                fail(f"phase 13: a net axis on {cards} card raised without naming the cards: {err}")
            print(f"net axis: not exercised on this machine ({cards} card visible): "
                  f"mesh.extra_axes=(('net', 2),) raised as it must ({err}); nothing falls back "
                  f"to CPU ranks or to two ranks on one card. tests/test_torch_net_axis.py runs "
                  f"the axis over gloo CPU ranks; a machine with 2 or 4 cards runs it here",
                  flush=True)
            return {}
        fail("phase 13: a net axis on one card did not raise")
    return {world: run_net_layout(scratch, world, chaos, chaos_log, data_axis, profile)
            for world in ((2, 4) if cards >= 4 else (2,))}


# ------------------------------- phase 14 -------------------------------

SPACE_LAYOUTS = {2: (("space", 2),), 4: (("net", 2), ("space", 2))}


def space_axis_config(world: int):
    """Phase 5's CHAOS point with the image rows split over the cards: space
    2 on 2 cards, net 2 x space 2 on 4 (0: every visible card, space 2)."""
    cfg = chaos_config()
    cfg.mesh.num_devices = world
    cfg.mesh.extra_axes = SPACE_LAYOUTS.get(world, SPACE_LAYOUTS[2])
    return cfg


def space_axis_rank(rank, device, scratch, world, profile=False):
    """Phase 14 on one rank (a process of ``mesh.launch``, on its card):
    phase 5's CHAOS point, Trainer.run(2) on this rank's rows of each image
    (and, at net 2 x space 2, with net (rank // 2) % 2 of the pair), driven
    as phase 5's; its own files under ``scratch/rank{rank}``. Returns what
    the phase compares across ranks and with phase 5. A failed check exits
    this rank non-zero, which ends the launch."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.trainer import Trainer
    from aide_tpu_torch.ops import cuda_warp

    work = fresh_dir(os.path.join(scratch, f"rank{rank}"))
    cfg = space_axis_config(world)
    cfg.checkpoint_dir = os.path.join(work, "ckpt")
    cfg.history_dir = os.path.join(work, "hist")
    cfg.data.tempmask_folder = "tempmasks"
    task = chaos_task(os.path.join(work, "chaos"))
    release_device_memory()
    trainer = Trainer(cfg, task, device=device)
    trainer.label_cases = set(task.clean_case_ids())
    if (trainer.world != world or trainer.device != device or mesh.space_shards() != 2
            or mesh.space_rank() != rank % 2):
        fail(f"rank {rank}: trainer on {trainer.device} at world {trainer.world}, space "
             f"{mesh.space_shards()} shard {mesh.space_rank()}")
    per_step, inner = [], trainer.train_step

    def counted(*args):
        before = {k: list(v) for k, v in mesh.by_kind.items()}
        out = inner(*args)
        per_step.append({k: [v[0] - before.get(k, [0, 0])[0], v[1] - before.get(k, [0, 0])[1]]
                         for k, v in mesh.by_kind.items()})
        return out

    trainer.train_step = counted
    mesh.reset_collectives()
    run = drive(trainer, cuda_warp)
    trainer.train_step = inner
    nets = [digest([t for _, t in sorted(net.state_dict().items())]) for net in trainer.state.nets]
    # the halo exchanges' device time a step, from the profile's trace
    halo = (profile_steps(f"space axis, world {world}", trainer)["halo_ms_per_step"]
            if profile else None)
    labels, blocks_ok, tempmasks_ok = rank_label_checks(trainer, task, rank)
    v, b = cfg.data.num_tta_views, cfg.data.batch_size
    views = v * b * (2 if world == 2 else 1)
    window_vs_plain(cuda_warp, (v * b, 256, 256, 3), False, 2, device, seed=rank)
    window_vs_plain(cuda_warp, (views, 256, 256, 2), True, 2, device, seed=rank)
    return dict(
        rank=rank, device=str(device), world=mesh.world_size(), net_size=mesh.net_size(),
        space_rank=mesh.space_rank(), index=getattr(trainer.state, "index", None),
        name=torch.cuda.get_device_name(device),
        rows=run["rows"], case_dice=run["case_dice"], refresh_log=list(trainer.refresh_log),
        steady=run["steady"], step_ms=run["step_ms"], spe=run["spe"], peak=run["peak"],
        launches=run["launches"], outside=run["outside"], best_epochs=run["best_epochs"],
        step_launches=run["step_launches"], replayed=run["replayed"], replays=run["replays"],
        step_upsample=run["step_upsample"], upsample_per_step=run["upsample_per_step"],
        by_kind=per_step[-1], halo_ms=halo, nets=nets,
        labels=digest(labels), blocks_ok=blocks_ok, tempmasks_ok=tempmasks_ok, warp_err=0.0,
        files=sorted(os.path.relpath(os.path.join(d, f), work)
                     for d, _, fs in os.walk(work) for f in fs if "tempmasks" in d or
                     d.endswith(("ckpt", "hist"))),
    )


def run_space_layout(scratch, world, chaos, chaos_log, profile=False):
    """Phase 14 (a) or (b): phase 5's CHAOS point through ``mesh.launch`` on
    ``world`` cards with the rows split over a space axis of 2. Holds rank
    0's history and refresh decisions to phase 5's (``hold_to_phase5``),
    the ranks of each net to equal parameters and BN statistics, every rank
    to the same history and working labels (host and device), the files to
    rank 0 alone, 3 warp launches a step on every rank, and rank 0's
    ``_last_full`` to the ranks' nets through a one-process Trainer."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine import checkpoint as ckpt
    from aide_tpu_torch.engine.trainer import Trainer

    name = "space axis 2" if world == 2 else "space axis net 2 x space 2"
    work = fresh_dir(os.path.join(scratch, f"space_axis_{world}"))
    release_device_memory()
    t0 = time.perf_counter()
    try:
        ranks = mesh.launch(space_axis_rank, space_axis_config(world), "cuda",
                            (work, world, profile))
    except Exception as err:  # a rank that failed ends the launch
        fail(f"phase 14: the space axis on {world} cards failed: {err}")
    seconds = time.perf_counter() - t0
    net = 2 if world == 4 else 1
    if sorted(ranks) != list(range(world)) or any(
            (r["world"], r["net_size"], r["space_rank"]) != (world, net, i % 2)
            for i, r in ranks.items()):
        fail(f"phase 14: ranks {sorted(ranks)}: "
             f"{[(r['world'], r['net_size'], r['space_rank']) for r in ranks.values()]}")
    r0 = ranks[0]
    print(f"{name}: world {world} over NCCL, space 2, net {net}, {torch.cuda.device_count()} "
          f"cards visible; devices {[ranks[r]['device'] for r in sorted(ranks)]}; "
          f"{seconds:.1f} s", flush=True)
    for r in sorted(ranks):
        res = ranks[r]
        halo = ("not measured (no --profile)" if res["halo_ms"] is None else
                f"{res['halo_ms']:.3f} ms a step (the device time of their NCCL kernels in the "
                f"--profile trace)")
        print(f"{name} rank {r} ({res['device']}, {res['name']}, space shard "
              f"{res['space_rank']}, net {res['index']}): median step {res['steady']:.3f} ms, "
              f"max_memory_allocated {res['peak']} bytes, warp launches {res['launches']} "
              f"({res['outside']} outside the train steps), collectives a step by kind "
              f"[count, bytes] {json.dumps(res['by_kind'])}, halo exchanges {halo}", flush=True)
    print_run(name.replace(" ", "_"), r0)
    print(f"{name}: median step {r0['steady']:.3f} ms (ranks "
          f"{[round(ranks[r]['steady'], 3) for r in sorted(ranks)]}), phase 5 (one card) "
          f"{chaos['steady']:.3f} ms; peak {r0['peak']} bytes a rank against phase 5's "
          f"{chaos['peak']}", flush=True)

    def metrics(res):
        return [{k: v for k, v in row.items() if not k.startswith("time")} for row in res["rows"]]

    for r in sorted(ranks)[1:]:
        other = ranks[r]
        if (other["labels"], other["refresh_log"], metrics(other)) != (
                r0["labels"], r0["refresh_log"], metrics(r0)):
            fail(f"phase 14: rank {r} ends with other labels or history than rank 0")
        twin = ranks[r - r % 2]  # the other space shard of its block holds the same nets
        if other["nets"] != twin["nets"]:
            fail(f"phase 14: rank {r} ends with other parameters than rank {r - r % 2}")
        if other["files"]:
            fail(f"phase 14: rank {r} wrote files: {other['files'][:5]}")
    for r, res in ranks.items():
        if launch_fault(res, 3):
            fail(f"phase 14: rank {r}: {launch_fault(res, 3)}")
        if not (res["blocks_ok"] and res["tempmasks_ok"]):
            fail(f"phase 14: rank {r}: device labels {res['blocks_ok']}, tempmasks "
                 f"{res['tempmasks_ok']}")
        if res["by_kind"] != r0["by_kind"]:
            fail(f"phase 14: rank {r} ran other collectives than rank 0: {res['by_kind']}")
    wanted = ("_history.json", ".log", "_last_full.msgpack", "_besttraincasedice.pkl", ".png")
    if not all(any(f.endswith(w) for f in r0["files"]) for w in wanted):
        fail(f"phase 14: rank 0 did not write every file: {r0['files']}")
    hold_to_phase5("phase 14", name, name, r0, chaos, chaos_log)
    cfg = chaos_config()
    cfg.resume_file = ckpt.full_path(os.path.join(work, "rank0", "ckpt"), cfg.experiment_name,
                                     last=True)
    cfg.checkpoint_dir = fresh_dir(os.path.join(work, "resume", "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(work, "resume", "hist"))
    resumed = Trainer(cfg, chaos_task(os.path.join(work, "rank0", "chaos")))
    got = [digest([t for _, t in sorted(n.state_dict().items())]) for n in resumed.state.nets]
    held = r0["nets"] if net == 1 else r0["nets"] + ranks[2]["nets"]
    if got != held or resumed.start_epoch != 2:
        fail(f"phase 14: rank 0's _last_full does not hold the ranks' nets ({got} against "
             f"{held}, next epoch {resumed.start_epoch})")
    print(f"{name}: rank 0's _last_full ({os.path.getsize(cfg.resume_file)} bytes) resumes in "
          f"one process at epoch {resumed.start_epoch + 1} with the pair equal to the ranks' "
          f"nets bit for bit", flush=True)
    del resumed
    release_device_memory()
    return dict(r0, ranks=ranks, seconds=seconds)


def kidney_steps(trainer) -> dict:
    """One train epoch of a supervised trainer (8 steps at the kidney
    shapes): its metrics, the step times and the peak memory."""
    import torch

    step_ms, inner = [], trainer.train_step

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.train_step = timed
    release_device_memory()
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer._train_epoch(0, 0.0)
    torch.cuda.synchronize()
    trainer.train_step = inner
    return dict(metrics=metrics, step_ms=step_ms, steady=statistics.median(step_ms[1:]),
                peak=torch.cuda.max_memory_allocated())


def kidney_space_rank(rank, device, scratch):
    """Phase 14 (c) on one rank: the supervised kidney comparison trainer's
    first epoch at space 2."""
    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = kidney_config("kidney_comparison_mask1", scratch, f"kidney_space_rank{rank}")
    cfg.mesh.num_devices, cfg.mesh.extra_axes = 2, (("space", 2),)
    trainer = Trainer(cfg, kidney_task(scratch, f"kidney_space_rank{rank}"), device=device)
    if mesh.space_shards() != 2:
        fail(f"phase 14 (c): rank {rank}: the space axis is not live")
    return kidney_steps(trainer)


def run_kidney_space(scratch):
    """Phase 14 (c): the kidney comparison preset's first supervised epoch
    at space 2 on 2 cards against the same epoch on one card (the same
    seeds): the losses and dice within rtol 2e-2, and a rank's peak under
    the card's."""
    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.engine.trainer import Trainer

    cfg = kidney_config("kidney_comparison_mask1", scratch, "kidney_space_one")
    release_device_memory()
    one = kidney_steps(Trainer(cfg, kidney_task(scratch, "kidney_space_one")))
    release_device_memory()
    cfg2 = kidney_config("kidney_comparison_mask1", scratch, "kidney_space_launch")
    cfg2.mesh.num_devices, cfg2.mesh.extra_axes = 2, (("space", 2),)
    try:
        ranks = mesh.launch(kidney_space_rank, cfg2, "cuda", (scratch,))
    except Exception as err:
        fail(f"phase 14 (c): the kidney preset at space 2 failed: {err}")
    for r in sorted(ranks):
        res = ranks[r]
        print(f"kidney at space 2 rank {r}: train {json.dumps(res['metrics'])}, median step "
              f"{res['steady']:.3f} ms, max_memory_allocated {res['peak']} bytes; one card: "
              f"train {json.dumps(one['metrics'])}, median step {one['steady']:.3f} ms, "
              f"max_memory_allocated {one['peak']} bytes ({res['peak'] / one['peak']:.3f}x)",
              flush=True)
        for key, v in one["metrics"].items():
            if not math.isclose(res["metrics"][key], v, rel_tol=2e-2, abs_tol=2e-3):
                fail(f"phase 14 (c): rank {r} {key} {res['metrics'][key]} against one card's {v}")
        if not res["peak"] < one["peak"]:
            fail(f"phase 14 (c): rank {r}'s peak {res['peak']} is not under one card's "
                 f"{one['peak']}")
    return dict(one=one, ranks=ranks)


def run_space_axis(scratch, chaos, chaos_log, profile=False):
    """Phase 14: the space axis on the cards of this machine: (a) space 2 on
    2 cards and, with 4, (b) net 2 x space 2 (``run_space_layout``), then
    (c) the kidney preset at space 2 (``run_kidney_space``). With one card,
    the windowed kernel at (a)'s per-rank shapes against its plain version
    (phase 3 checks them too) and the refusal that names the cards; it says
    that the layouts were not exercised there. Returns ({world: run}, (c))."""
    import torch

    from aide_tpu_torch.core import mesh
    from aide_tpu_torch.ops import cuda_warp

    cards = torch.cuda.device_count()
    if cards < 2:
        for _, shape, inverse, _, k in WINDOW_LAUNCHES[:2]:
            window_vs_plain(cuda_warp, shape, inverse, k, torch.device("cuda"), seed=14)
        try:
            mesh.launch(space_axis_rank, space_axis_config(0), "cuda", (scratch, 2, profile))
        except ValueError as err:
            if "card" not in str(err):
                fail(f"phase 14: a space axis on {cards} card raised without naming the cards: "
                     f"{err}")
            print(f"space axis: not exercised on this machine ({cards} card visible): "
                  f"mesh.extra_axes=(('space', 2),) raised as it must ({err}); the windowed "
                  f"kernel at (a)'s per-rank shapes equals its plain version. "
                  f"tests/test_torch_space_axis.py and tests/test_torch_space_epoch.py run the "
                  f"axis over gloo CPU ranks; a machine with 2 or 4 cards runs it here",
                  flush=True)
            return {}, None
        fail("phase 14: a space axis on one card did not raise")
    runs = {world: run_space_layout(scratch, world, chaos, chaos_log, profile)
            for world in ((2, 4) if cards >= 4 else (2,))}
    return runs, run_kidney_space(scratch)


# ------------------------------- phase 15 -------------------------------

# the bench's points, one `python -m aide_tpu_torch.bench` process each:
# (subphase, path, arguments, warp launches a step; None: no train step)
BENCH_RUNS = (
    ("a", "bench_chaos", ("--task", "chaos"), 3),
    ("b", "bench_chaos_eval_volume", ("--task", "chaos", "--eval-volume"), None),
    ("c", "bench_kidney", ("--task", "kidney", "--steps-only"), 2),
    ("d", "bench_chaos_supervised", ("--task", "chaos", "--supervised", "--steps-only"), 0),
)
# 990 synthetic CHAOS slices at batch 8, the last partial batch dropped
BENCH_CHAOS_STEPS = 123
BENCH_TIMEOUT_S = 420
H100_BF16_TFLOPS = 989.5  # dense, NVIDIA's H100 SXM5 data sheet (1,979 with sparsity)


def image_flops(model_cfg, size: int, two_modal: bool, device) -> tuple:
    """FlopCounterMode's count of one image through the net a ModelConfig
    names: its forward without gradient, and its forward and backward with
    the input outside the graph (the main forward of a train step)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from aide_tpu_torch.models import build_model

    net = build_model(model_cfg).to(device, memory_format=torch.channels_last)
    x = torch.zeros((1, size, size, 3), device=device)
    ins = (x, x) if two_modal else (x,)
    with FlopCounterMode(display=False) as forward, torch.no_grad():
        net(*ins)
    with FlopCounterMode(display=False) as both:
        net(*ins).sum().backward()
    return forward.get_total_flops(), both.get_total_flops()


def check_bench_flops(bench, device) -> None:
    """The bench's model FLOPs a step against the count of one image's
    forward F and forward-and-backward FB on the card: a co-teaching step
    is 2 nets x 4 views x B view forwards and 2 x B main forwards with
    their backward, a supervised step B forwards with their backward. The
    card's count under bf16 autocast at 64 px equals the CPU's in f32, so
    cuDNN's convolutions (forward, grad-input, grad-weight) count once."""
    from aide_tpu_torch.core.config import ModelConfig

    chaos = ModelConfig(name="fuseunet", compute_dtype="bfloat16")
    card = image_flops(chaos, 64, True, device)
    host = image_flops(ModelConfig(name="fuseunet", compute_dtype="float32"), 64, True, "cpu")
    print(f"phase 15: FuseUNet-32 at 64 px, one image: forward, forward+backward {card} "
          f"FLOP on the card (bf16 autocast), {host} on the CPU (f32)", flush=True)
    if card != host:
        fail(f"phase 15: the card counts {card} FLOP where the CPU counts {host}")
    f, fb = image_flops(chaos, 256, True, device)
    want = {"a": 2 * 4 * 8 * f + 2 * 8 * fb, "d": 8 * fb}
    f, fb = image_flops(ModelConfig(name="unet", compute_dtype="bfloat16"), 512, False, device)
    want["c"] = 2 * 4 * 8 * f + 2 * 8 * fb
    for sub, n in want.items():
        got = bench[sub]["model_flops_per_step"]
        print(f"phase 15 ({sub}): {got} model FLOP a step, {n} from one image's counts",
              flush=True)
        if got != n:
            fail(f"phase 15 ({sub}): the bench counts {got} FLOP a step, one image's "
                 f"counts give {n}")


def check_bench_row(sub, argv, row, per_step, device_name) -> None:
    """One bench line against the contract of phase 15."""
    value = row.get("value")
    if not (isinstance(value, (int, float)) and math.isfinite(value) and value > 0):
        fail(f"phase 15 ({sub}): value {value!r}")
    # the reference's seconds a volume, a supervised epoch, a co-teaching epoch
    baseline = 3.0 if per_step is None else 300.0 if "--supervised" in argv else 420.0
    if abs(row["vs_baseline"] - baseline / value) > 0.02 * baseline / value:
        fail(f"phase 15 ({sub}): vs_baseline {row['vs_baseline']} against {baseline} / {value}")
    if row["device_name"] != device_name or row["power_limit_w"] is None:
        fail(f"phase 15 ({sub}): device {row['device_name']!r}, power limit "
             f"{row['power_limit_w']!r} (this card: {device_name!r})")
    if per_step is None:
        print(f"phase 15 ({sub}): host largest-CC on {row['cc_volumes']} raw predicted volumes "
              f"of {row['slices_per_volume']} x {row['img_size']} x {row['img_size']}: native "
              f"{row['cc_native_ms_per_volume']:.3f} ms a volume, plain "
              f"{row['cc_plain_ms_per_volume']:.3f} ms, outputs equal: "
              f"{row['cc_outputs_equal']}", flush=True)
        if row["cc_outputs_equal"] is not True:
            fail(f"phase 15 ({sub}): the native largest-CC differs from its plain twin")
        return
    # the bench warms the step until it replays its graph: every timed
    # step replays, and the host calls no kernel in them
    if row["graph_replays_timed"] != row["bare_steps"] or row["warp_launches_timed"] != 0:
        fail(f"phase 15 ({sub}): {row['graph_replays_timed']} of {row['bare_steps']} timed steps "
             f"replayed, {row['warp_launches_timed']} host-called warp launches in them")
    mfu = row["train_step_mfu"]
    if device_name == "NVIDIA H100 80GB HBM3":
        if row["peak_tflops"] != H100_BF16_TFLOPS or not (isinstance(mfu, float) and 0 < mfu < 1):
            fail(f"phase 15 ({sub}): MFU {mfu!r} against a peak of {row['peak_tflops']!r}")
    elif mfu is not None or row["peak_tflops"] is not None:
        fail(f"phase 15 ({sub}): a peak {row['peak_tflops']!r} and MFU {mfu!r} for a card the "
             "table lacks")
    for r in row["history"]:
        bad = {k: v for k, v in r.items() if not math.isfinite(v)}
        if bad:
            fail(f"phase 15 ({sub}): epoch {r['epoch']} has non-finite values {bad}")
    if row["mfu_basis"] != "model" or not row["model_flops_per_step"] > 0:
        fail(f"phase 15 ({sub}): FLOPs {row['model_flops_per_step']!r} ({row['mfu_basis']})")
    if sub == "a":
        if row["train_steps_per_epoch"] != BENCH_CHAOS_STEPS or "partial" in row:
            fail(f"phase 15 (a): {row['train_steps_per_epoch']} train steps, partial "
                 f"{row.get('partial')!r}; expected the full epoch's {BENCH_CHAOS_STEPS}")
        eager = BENCH_CHAOS_STEPS - row["graph_replays_epoch"]
        if row["warp_launches_epoch"] != per_step * eager:
            fail(f"phase 15 (a): {row['warp_launches_epoch']} host-called warp launches in the "
                 f"epoch, expected {per_step} in each of its {eager} steps that did not replay")
        missing = {"time_train", "time_test", "time_cases", "time_ckpt", "time_refresh"} - set(row)
        if missing or len(row["history"]) != 2:
            fail(f"phase 15 (a): phases {sorted(missing)} missing, {len(row['history'])} epochs")
    elif row.get("partial") != "steps_only":
        fail(f"phase 15 ({sub}): partial {row.get('partial')!r} on a --steps-only run")


def run_bench(root, scratch) -> dict:
    """Phase 15: the bench's points on this card, each in its own process
    (stderr under build/chip_smoke/bench/), held to the contract; returns
    each subphase's line with its seconds."""
    import torch

    release_device_memory()
    work = fresh_dir(os.path.join(scratch, "bench"))
    env = dict(os.environ, TMPDIR=os.path.join(work, "tmp"))
    os.makedirs(env["TMPDIR"])
    device_name = torch.cuda.get_device_name(0)
    out = {}
    for sub, path, argv, per_step in BENCH_RUNS:
        cmd = [sys.executable, "-m", "aide_tpu_torch.bench", *argv]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                                  timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"phase 15 ({sub}): {' '.join(cmd[1:])} ran past {BENCH_TIMEOUT_S} s")
        secs = time.perf_counter() - t0
        with open(os.path.join(work, f"{path}.log"), "w") as fh:
            fh.write(proc.stderr)
        if proc.returncode:
            fail(f"phase 15 ({sub}): {' '.join(cmd[1:])} exited {proc.returncode}:\n"
                 f"{proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        try:
            row = json.loads(lines[-1])
        except (IndexError, ValueError) as err:
            fail(f"phase 15 ({sub}): no JSON line ({err}): {proc.stdout[-2000:]}")
        print(f"phase 15 ({sub}) python -m aide_tpu_torch.bench {' '.join(argv)}: {secs:.2f} s",
              flush=True)
        print(json.dumps({k: v for k, v in row.items() if k != "history"}), flush=True)
        for r in row.get("history", []):
            print(f"phase 15 ({sub}) epoch {r['epoch']}: " + json.dumps(r), flush=True)
        check_bench_row(sub, argv, row, per_step, device_name)
        out[sub] = dict(row, path=path, seconds=secs)
    check_bench_flops(out, torch.device("cuda"))
    return out


# ------------------------------- phase 16 -------------------------------

# the flagship two-modal pseudo ladder at full width, its epochs cut to 3 a
# stage (the AIDE stage's warmup max(2, 3 // 3) = 2: two refreshes, the
# label-quality oracle and the end-of-ramp verdict)
LADDER_ARGV = ("--style", "xhard", "--protocol", "pseudo", "--two-modal", "--model", "fuseunet",
               "--img-size", "128", "--num-cases", "30", "--clean-cases", "1",
               "--slices-per-case", "30", "--ceiling", "--epochs", "3", "--pretrain-epochs", "3")
LADDER_TIMEOUT_S = 600
LADDER_STAGES = ("aide", "ceiling", "naive", "pretrain")
# the JAX program's summary keys under the pseudo protocol with --ceiling
LADDER_SUMMARY_KEYS = {
    "style", "protocol", "seed", "model", "two_modal", "slices_per_case", "noisy_fraction",
    "noise_shift_divisor", "clean_cases", "num_cases", "ceiling_best_dice", "img_size",
    "pretrain_best_dice", "naive_best_dice", "aide_best_dice", "aide_over_naive",
    "aide_over_pretrain"}


def run_ladder(root, scratch) -> dict:
    """Phase 16 (a): ``python -m aide_tpu_torch.experiments.synthetic_aide``
    at the flagship point (LADDER_ARGV) in its own process (its log under
    build/chip_smoke/ladder/), held to the program's contract; returns its
    stages, summary, seconds and the AIDE stage's epoch times."""
    import glob
    from types import SimpleNamespace

    import torch

    from aide_tpu_torch.engine.trainer import Trainer
    from aide_tpu_torch.experiments import synthetic_aide as SA

    release_device_memory()
    work = fresh_dir(os.path.join(scratch, "ladder"))
    out_file = os.path.join(work, "ladder.json")
    cmd = [sys.executable, "-m", "aide_tpu_torch.experiments.synthetic_aide", *LADDER_ARGV,
           "--workdir", os.path.join(work, "run"), "--out", out_file]
    env = dict(os.environ, TMPDIR=os.path.join(work, "tmp"))
    os.makedirs(env["TMPDIR"])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                              timeout=LADDER_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 16: {' '.join(cmd[1:])} ran past {LADDER_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    with open(os.path.join(work, "ladder.log"), "w") as fh:
        fh.write(proc.stderr)
    if proc.returncode:
        fail(f"phase 16: {' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines = []
    for ln in proc.stdout.splitlines():
        if ln.strip():
            try:
                lines.append(json.loads(ln))
            except ValueError:
                fail(f"phase 16: a line of the program's output is not JSON: {ln!r}")
    with open(out_file) as fh:
        saved = json.load(fh)
    runs, summary = saved["runs"], saved["summary"]
    print(f"phase 16 (a) python -m aide_tpu_torch.experiments.synthetic_aide "
          f"{' '.join(LADDER_ARGV)}: {secs:.2f} s", flush=True)
    print(json.dumps(summary), flush=True)
    missing = (LADDER_SUMMARY_KEYS | {"device_name", "power_limit_w"}) - set(summary)
    if not lines or lines[-1] != summary or missing:
        fail(f"phase 16: the summary line {lines[-1:]} lacks {sorted(missing)}")
    if summary["device_name"] != torch.cuda.get_device_name(0) or summary["power_limit_w"] is None:
        fail(f"phase 16: device {summary['device_name']!r}, power limit "
             f"{summary['power_limit_w']!r}")
    quality = [ln["pseudo_label_quality"] for ln in lines if "pseudo_label_quality" in ln]
    if len(quality) != 2 or not all(0.0 < q <= 1.0 for q in quality):
        fail(f"phase 16: pseudo_label_quality {quality} (one a pseudo-labelled stage, in (0, 1])")
    if sorted(runs) != list(LADDER_STAGES):
        fail(f"phase 16: stages {sorted(runs)}")
    epoch_s = {}
    for stage in LADDER_STAGES:
        r = runs[stage]
        files = glob.glob(os.path.join(work, "run", f"hist_{stage}", "*_history.json"))
        if len(files) != 1:
            fail(f"phase 16 {stage}: history files {files}")
        with open(files[0]) as fh:
            history = json.load(fh)
        bad = [(row["epoch"], k) for row in history for k, v in row.items()
               if not math.isfinite(v)]
        if len(history) != r["epochs"] or bad:
            fail(f"phase 16 {stage}: {len(history)} epochs of {r['epochs']}, non-finite {bad}")
        epoch_s[stage] = [row["time"] for row in history]
        per_step = 3 if stage == "aide" else 0
        eager = r["train_steps"] - r["graph_replays"]
        if r["train_steps"] <= 0 or r["warp_launches"] != per_step * eager:
            fail(f"phase 16 {stage}: {r['warp_launches']} host-called warp launches in "
                 f"{r['train_steps']} train steps, {r['graph_replays']} of them replayed; "
                 f"expected {per_step} in each of the other {eager}")
        if not os.path.exists(r["checkpoint"]):
            fail(f"phase 16 {stage}: no export at {r['checkpoint']}")
        print(f"phase 16 (a) {stage}: {r['seconds']:.2f} s, epochs {epoch_s[stage]} s, best "
              f"test-case dice {r['best_testcase_dice']:.4f}, {r['train_steps']} steps, "
              f"{r['graph_replays']} replayed, {r['warp_launches']} host-called warp launches",
              flush=True)
    aide = runs["aide"]
    # the refresh epochs by the trainer's rule at the AIDE stage's config
    SA.PROTOCOL = "pseudo"
    probe = SimpleNamespace(cfg=SA.build_cfg("aide", work, aide["epochs"]))
    want = [e + 1 for e in range(aide["epochs"]) if Trainer._is_refresh_epoch(probe, e)]
    track = [t["epoch"] for t in aide["label_quality_track"]]
    if not want or track != want or "engagement" not in aide:
        fail(f"phase 16 aide: label-quality track at epochs {track} (refresh epochs {want}), "
             f"engagement {aide.get('engagement')!r}")
    print("phase 16 (a) aide: label quality " + json.dumps(aide["label_quality_track"])
          + ", engagement " + json.dumps(aide["engagement"]), flush=True)
    return dict(runs=runs, summary=summary, seconds=secs, epoch_s=epoch_s)


def ladder_small_aide(SA, device, work, pretrain, weights, seed) -> dict:
    """Phase 16 (b) on ``device``: apply_pseudo_labels from ``pretrain``,
    then one AIDE epoch with refresh from ``weights`` (None: the nets drawn
    from ``seed``) and seeded view parameters. Returns the pseudo-labels
    and their quality, the rows, refresh log and case dice, the working
    labels and the initial weights."""
    import numpy as np
    import torch

    from aide_tpu_torch.engine.trainer import init_weights

    rec = {"case_dice": {}}

    def prepare(tr, stage):
        for n, net in enumerate(tr.state.nets):
            if weights is None:
                init_weights(net, 100 * seed + n)
            else:
                net.load_state_dict(weights[n])
        rec["weights"] = [{k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                          for net in tr.state.nets]
        rec["pseudo"] = [tr.train_pipe.labels.get(n).copy() for n in (1, 2)]

        def view_params(epoch, step, b):
            g = np.random.default_rng(1000 * epoch + step)
            v = tr.cfg.data.num_tta_views
            views = (g.uniform(-45, 45, (v, b)).astype(np.float32),
                     (g.random((v, b)) < 0.5).astype(np.float32))
            return tuple(torch.from_numpy(x).to(tr.device) for x in views)

        tr.view_params = view_params
        inner = tr._refresh_labels

        def refresh(epoch, traincase):
            for n in traincase:
                rec["case_dice"][epoch, n] = {r.case_id: r.dice for r in traincase[n]}
            inner(epoch, traincase)

        tr._refresh_labels = refresh
        rec["trainer"] = tr

    SA.DEVICE = device
    result = SA.run("aide", fresh_dir(os.path.join(work, f"aide_{device}")), 1,
                    pseudo_from=pretrain, prepare=prepare)
    tr = rec.pop("trainer")
    k = int(tr.cfg.coteach.update_percent * len(tr.train_cases))
    return dict(rec, q=result["engagement_probe"]["bootstrap_skill1"], rows=tr.history,
                log=tr.refresh_log, labels=[tr.train_pipe.labels.get(n) for n in (1, 2)], k=k)


def ladder_vs_cpu(scratch) -> dict:
    """Phase 16 (b): the ladder's pseudo-labelling and an AIDE epoch after
    it at phase 6's small size (two-modal FuseUNet at base width 4, 32 px,
    f32, TF32 off, 6 cases x 8 slices, 1 clean, lr 1e-6 and the worst half
    refreshed in the AIDE stage),
    on the card and on the CPU from one pretrain export (trained on the
    CPU), the same initial nets and view parameters: pseudo-labels equal in
    >= 99.9% of voxels, pseudo_label_quality within 1e-3, the same refresh
    decisions each with a margin (the CPU run's seeds drawn until its
    worst-k boundaries have a gap of 1e-3, else the widest, as phase 6
    draws them, and a refresh rewrites a case), working labels within
    Dice 0.995, history metrics within 1e-3."""
    import numpy as np
    import torch

    from aide_tpu_torch.evaluation.case_eval import dice3d_np
    from aide_tpu_torch.experiments import synthetic_aide as SA

    settings = dict(NUM_CASES=6, CLEAN_CASES=1, SLICES_PER_CASE=8, MODEL="fuseunet",
                    IMG_SIZE=32, SEED=8, STYLE="xhard", PROTOCOL="pseudo", TWO_MODAL=True,
                    # the worst 3 of 6 cases a net: the labeled case, which
                    # fresh nets score worst, and two that are rewritten
                    AIDE_OVERRIDES=["coteach.update_percent=0.5"])
    saved = {k: getattr(SA, k) for k in (*settings, "build_cfg", "DEVICE")}
    base = SA.build_cfg

    def small_cfg(stage, workdir, epochs, resume=""):
        cfg = base(stage, workdir, epochs, resume)
        cfg.model.base_width = 4
        cfg.model.compute_dtype = "float32"
        cfg.mesh.num_devices = 1
        if stage == "aide":
            cfg.optim.lr = 1e-6  # as phase 6 trains
        return cfg

    for key, value in settings.items():
        setattr(SA, key, value)
    SA.build_cfg = small_cfg
    torch.backends.cudnn.allow_tf32 = False
    try:
        work = fresh_dir(os.path.join(scratch, "ladder_small"))
        SA.DEVICE = "cpu"
        pretrain = SA.run("pretrain", os.path.join(work, "pretrain"), 6)["checkpoint"]
        if not os.path.exists(pretrain):
            fail(f"phase 16 (b): the pretrain wrote no export at {pretrain}")
        # the first seed whose every worst-k boundary has a gap of 1e-3, else
        # the widest of seeds 0-9
        best = None
        for seed in range(10):
            cpu = ladder_small_aide(SA, "cpu", work, pretrain, None, seed)
            gaps = boundary_gaps(cpu["case_dice"], cpu["k"])
            if len(gaps) != len(cpu["log"]) or not any(done for *_, done in cpu["log"]):
                continue
            if best is None or min(gaps.values()) > min(best[2].values()):
                best = (seed, cpu, gaps)
            if min(gaps.values()) >= 1e-3:
                break
        if best is None or min(best[2].values()) <= 0.0:
            fail("phase 16 (b): no seed in 0-9 gives the CPU run a refresh that rewrites a "
                 "case without a tie")
        seed, cpu, gaps = best
        gpu = ladder_small_aide(SA, "cuda", work, pretrain, cpu["weights"], seed)
    finally:
        torch.backends.cudnn.allow_tf32 = True
        for key, value in saved.items():
            setattr(SA, key, value)
    agree = [float(np.mean(g == c)) for g, c in zip(gpu["pseudo"], cpu["pseudo"])]
    label_dice = [dice3d_np(g, c) for g, c in zip(gpu["labels"], cpu["labels"])]
    worst = worst_difference(gpu["rows"], cpu["rows"])
    margins = [(gaps[key], max(abs(gpu["case_dice"][key][c] - d)
                               for c, d in cpu["case_dice"][key].items()))
               for key in sorted(cpu["case_dice"])]
    name = "phase 16 (b) the ladder's small slice, card vs CPU"
    print(f"{name} (seed {seed}): pseudo-label voxel agreement {agree}, quality "
          f"{gpu['q']:.6f} / {cpu['q']:.6f}; refresh decisions {gpu['log']} / {cpu['log']}, "
          f"margins (CPU gap, largest card-CPU case-dice difference) {json.dumps(margins)}; "
          f"working-label agreement {label_dice}; worst metric difference {worst:.3e}",
          flush=True)
    if min(agree) < 0.999 or abs(gpu["q"] - cpu["q"]) > 1e-3:
        fail(f"{name}: pseudo-labels agree in {agree} of voxels, quality {gpu['q']} vs {cpu['q']}")
    if gpu["log"] != cpu["log"] or not all(gap > diff for gap, diff in margins):
        fail(f"{name}: refresh decisions {gpu['log']} vs {cpu['log']}, margins {margins}")
    if min(label_dice) < 0.995 or worst > 1e-3:
        fail(f"{name}: working labels agree to Dice {label_dice}, metrics differ by {worst}")
    return dict(pseudo_agreement=agree, quality=[gpu["q"], cpu["q"]], margins=margins,
                label_dice=label_dice, worst_metric_difference=worst)


# ------------------------------- phase 17 -------------------------------

# the real-data CHAOS programs at their own point (FuseUNet-32, bf16, 256
# px, batch 4, 4 views at +-60 degrees) on a fixture tree in the
# reference's layout, 3 epochs each: every epoch of the AIDE rungs a
# refresh (warmup 20), 20 train steps an epoch (80 slices, batch 4)
REAL_EPOCHS = 3
REAL_TIMEOUT_S = 300
# the JAX programs' keys
REAL_KEYS = {
    "chaos_real_1case": {"config", "epochs", "train_slices", "val_slices", "final_case10_dice",
                         "best_case10_dice", "golden_reference_case10_dice", "minutes"},
    "ladder_top": {"golden", "pretrain_rung", "naive", "aide", "aide_over_naive"},
    "naive": {"stage", "warm_start", "epochs", "initial_pseudo_quality", "final_case10_dice",
              "best_case10_dice", "golden_reference_case10_dice", "minutes"},
    "aide": {"stage", "warm_start", "epochs", "initial_pseudo_quality", "label_quality_track",
             "engagement_probe", "final_case10_dice", "best_case10_dice",
             "golden_reference_case10_dice", "minutes"},
    "chaos_real_proposed": {
        "config", "epochs", "train_slices", "bootstrap_label_dice_case10", "final_case10_dice",
        "best_case10_dice", "at_checkpoint_gate", "gate_epoch", "label_oracle_last",
        "label_oracle_peak", "golden_reference_case10_dice_supervised1case",
        "our_comparison_run_case10", "minutes", "label_oracle", "history"},
}
REAL_ADDED = {"seconds", "train_steps", "warp_launches", "graph_replays", "checkpoint"}
HALF_LIFE_WARNING = "STRUCTURAL REFRESH CHECK FAILED"


def tree_digest(path: str) -> str:
    """Every entry under ``path``: its name, a link's target, a file's bytes."""
    import hashlib

    h = hashlib.sha1()
    for top, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(dirs + files):
            full = os.path.join(top, name)
            h.update(os.path.relpath(full, path).encode())
            if os.path.islink(full):
                h.update(b"link:" + os.readlink(full).encode())
            elif os.path.isfile(full):
                with open(full, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


def real_program(root, work, tag, module, argv) -> tuple:
    """``python -m aide_tpu_torch.experiments.<module> argv`` in its own
    process (its log under ``work``); returns its seconds, JSON lines,
    ``#`` lines and the ``--out`` file's contents."""
    out_file = os.path.join(work, f"{tag}.json")
    cmd = [sys.executable, "-m", f"aide_tpu_torch.experiments.{module}", *argv,
           "--workdir", os.path.join(work, tag), "--out", out_file]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=REAL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"phase 17: {' '.join(cmd[1:])} ran past {REAL_TIMEOUT_S} s")
    secs = time.perf_counter() - t0
    with open(os.path.join(work, f"{tag}.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    if proc.returncode:
        fail(f"phase 17: {' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    lines, notes = [], []
    for ln in proc.stdout.splitlines():
        if ln.startswith("#"):
            notes.append(ln)
        elif ln.strip():
            try:
                lines.append(json.loads(ln))
            except ValueError:
                fail(f"phase 17 {tag}: a line of the program's output is not JSON: {ln!r}")
    with open(out_file) as fh:
        saved = json.load(fh)
    return secs, lines, notes, saved


def real_history(name, hist_dir, epochs) -> list:
    """The run's history file: ``epochs`` rows, every value finite."""
    import glob

    files = glob.glob(os.path.join(hist_dir, "*_history.json"))
    if len(files) != 1:
        fail(f"phase 17 {name}: history files {files}")
    with open(files[0]) as fh:
        history = json.load(fh)
    bad = [(row["epoch"], k) for row in history for k, v in row.items() if not math.isfinite(v)]
    if len(history) != epochs or bad:
        fail(f"phase 17 {name}: {len(history)} epochs of {epochs}, non-finite {bad}")
    return history


def check_real_run(name, r, want_keys, per_step, steps_per_epoch) -> None:
    """A run's keys (the JAX program's and the port's additions), its warp
    launches (``per_step`` a train step that did not replay its graph, by
    the host) and its export."""
    missing = (want_keys | REAL_ADDED) - set(r)
    if missing:
        fail(f"phase 17 {name}: the result lacks {sorted(missing)}")
    if r["train_steps"] != REAL_EPOCHS * steps_per_epoch:
        fail(f"phase 17 {name}: {r['train_steps']} train steps in {REAL_EPOCHS} epochs")
    eager = r["train_steps"] - r["graph_replays"]
    if r["warp_launches"] != per_step * eager:
        fail(f"phase 17 {name}: {r['warp_launches']} host-called warp launches in "
             f"{r['train_steps']} train steps, {r['graph_replays']} of them replayed; expected "
             f"{per_step} in each of the other {eager}")
    if not os.path.exists(r["checkpoint"]):
        fail(f"phase 17 {name}: no export at {r['checkpoint']}")


def check_card(name, info, card) -> None:
    """The program's output names the card and its power limit."""
    if info.get("device_name") != card or info.get("power_limit_w") is None:
        fail(f"phase 17 {name}: device {info.get('device_name')!r}, power limit "
             f"{info.get('power_limit_w')!r}")


def print_real(tag, secs, r, history) -> None:
    best = r["best_case10_dice"]
    print(f"phase 17 {tag}: {secs:.2f} s of command ({r['seconds']:.2f} s in the program), "
          f"{r['epochs']} epochs of {[row['time'] for row in history]} s, {r['train_steps']} "
          f"train steps, {r['graph_replays']} replayed, {r['warp_launches']} host-called warp "
          f"launches, best case-10 dice "
          f"{json.dumps(best)}", flush=True)


def run_real_programs(root, scratch) -> dict:
    """Phase 17 (a)-(f): the three real-data programs in their own
    processes on a 256 px fixture tree in the reference's layout, held to
    their contract; the tree unchanged after them. Returns each run's
    seconds, epoch times, steps and launches."""
    import torch

    from aide_tpu_torch.data.fixtures import write_reference_chaos

    release_device_memory()
    card = torch.cuda.get_device_name(0)
    work = fresh_dir(os.path.join(scratch, "real"))
    ref_dir = os.path.join(work, "reference")
    t0 = time.perf_counter()
    tree = write_reference_chaos(ref_dir, size=256, seed=0)
    digest = tree_digest(ref_dir)
    print(f"phase 17 (a) the reference tree at 256 px: {time.perf_counter() - t0:.2f} s, "
          f"bootstrap label dice {tree['pseudo_dice']:.6f}, digest {digest}", flush=True)
    common = ["--epochs", str(REAL_EPOCHS), "--reference", ref_dir]
    runs = {}

    # (b) the supervised pretrain rung
    secs, lines, _, one = real_program(root, work, "one", "chaos_real_1case", common)
    if not lines or lines[-1] != one:
        fail(f"phase 17 (b): the printed line {lines[-1:]} is not the --out file's")
    history = real_history("(b)", os.path.join(work, "one", "hist"), REAL_EPOCHS)
    check_real_run("(b)", one, REAL_KEYS["chaos_real_1case"], 0, 7)
    check_card("(b)", one, card)
    if (one["train_slices"], one["val_slices"]) != (30, 50):
        fail(f"phase 17 (b): {one['train_slices']} train and {one['val_slices']} val slices")
    print_real("(b) chaos_real_1case", secs, one, history)
    runs["real_1case"] = dict(one, command_s=secs, epoch_s=[row["time"] for row in history])

    # (c) both rungs of the ladder, (d) the warm AIDE rung from (b)'s export
    for tag, extra in (("ladder", ["--stage", "both"]),
                       ("warm", ["--stage", "aide", "--resume", one["checkpoint"]])):
        secs, lines, _, saved = real_program(root, work, tag, "chaos_real_ladder", common + extra)
        stages = ("naive", "aide") if tag == "ladder" else ("aide",)
        want_top = REAL_KEYS["ladder_top"] if tag == "ladder" else {"golden", "pretrain_rung",
                                                                     "aide"}
        if want_top - set(saved):
            fail(f"phase 17 {tag}: the summary lacks {sorted(want_top - set(saved))}")
        check_card(tag, saved, card)
        if lines[-1] != {k: v for k, v in saved.items() if k != "golden"}:
            fail(f"phase 17 {tag}: the last line is not the summary")
        for stage in stages:
            r = saved[stage]
            check_real_run(f"{tag} {stage}", r, REAL_KEYS[stage], 3 if stage == "aide" else 0, 20)
            history = real_history(f"{tag} {stage}", os.path.join(work, tag, f"hist_{stage}"),
                                   REAL_EPOCHS)
            print_real(f"({'c' if tag == 'ladder' else 'd'}) chaos_real_ladder {stage}"
                       f"{' warm' if tag == 'warm' else ''}", secs, r, history)
            runs[f"real_{tag}_{stage}"] = dict(r, command_s=secs,
                                               epoch_s=[row["time"] for row in history])
        aide = saved["aide"]
        track = [t["epoch"] for t in aide["label_quality_track"]]
        if track != list(range(1, REAL_EPOCHS + 1)) or aide["warm_start"] != (tag == "warm"):
            fail(f"phase 17 {tag}: label-quality track at epochs {track}, warm_start "
                 f"{aide['warm_start']}")
        with open(os.path.join(work, tag, "hist_aide", "fuseunet_temp1.0_r3.log")) as fh:
            if HALF_LIFE_WARNING not in fh.read():
                fail(f"phase 17 {tag}: no half-life warning in the AIDE rung's log")
        temp = os.path.join(work, tag, "tempmask_aide", "10")
        names = os.listdir(temp) if os.path.isdir(temp) else []
        if len(names) != 100:
            fail(f"phase 17 {tag}: {len(names)} tempmasks of case 10 under {temp}, expected 100")
        print(f"phase 17 {tag} aide: label quality " + json.dumps(aide["label_quality_track"])
              + f", initial pseudo quality {aide['initial_pseudo_quality']}", flush=True)
    initial = runs["real_ladder_aide"]["initial_pseudo_quality"]

    # (e) the proposed program
    secs, lines, notes, saved = real_program(root, work, "proposed", "chaos_real_proposed", common)
    r = {k: v for k, v in saved.items() if k not in ("label_oracle", "history")}
    if not lines or lines[-1] != r:
        fail("phase 17 (e): the printed line is not the --out file's")
    check_real_run("(e)", saved, REAL_KEYS["chaos_real_proposed"], 3, 20)
    check_card("(e)", saved, card)
    history = real_history("(e)", os.path.join(work, "proposed", "hist"), REAL_EPOCHS)
    oracle = [n for n in notes if n.startswith("# label oracle ")]
    if saved["train_slices"] != 80 or saved["bootstrap_label_dice_case10"] != initial:
        fail(f"phase 17 (e): {saved['train_slices']} train slices, bootstrap label dice "
             f"{saved['bootstrap_label_dice_case10']} against (c)'s {initial}")
    if len(oracle) != REAL_EPOCHS or len(saved["label_oracle"]) != REAL_EPOCHS:
        fail(f"phase 17 (e): {len(oracle)} oracle lines in {REAL_EPOCHS} refresh epochs")
    print_real("(e) chaos_real_proposed", secs, saved, history)
    print(f"phase 17 (e): label oracle {json.dumps(saved['label_oracle'])}", flush=True)
    runs["real_proposed"] = dict(r, command_s=secs, epoch_s=[row["time"] for row in history])

    # (f) nothing wrote under the reference tree
    if tree_digest(ref_dir) != digest:
        fail("phase 17 (f): the reference tree changed")
    print("phase 17 (f): the reference tree unchanged", flush=True)
    return runs


def real_ladder_small(PL, device, work, weights) -> dict:
    """Phase 17 (g) on ``device``: the ladder's AIDE rung for 2 epochs from
    ``weights`` (None: the trainer's own initial nets) and seeded view
    parameters. Returns the seeded labels as the device copy holds them,
    the case dice at each refresh, the rows, the refresh log, the oracle
    track and the working labels."""
    import numpy as np
    import torch

    rec = {"case_dice": {}}

    def prepare(tr, stage):
        for n, net in enumerate(tr.state.nets):
            if weights is not None:
                net.load_state_dict(weights[n])
        rec["weights"] = [{k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
                          for net in tr.state.nets]
        pipe = tr.train_pipe
        # a copy: on the CPU the device copy shares the host labels' memory
        rec["seeded"] = [pipe._device_labels[f"target{n}"].cpu().numpy().copy() for n in (1, 2)]

        def view_params(epoch, step, b):
            g = np.random.default_rng(1000 * epoch + step)
            v = tr.cfg.data.num_tta_views
            views = (g.uniform(-60, 60, (v, b)).astype(np.float32),
                     (g.random((v, b)) < 0.5).astype(np.float32))
            return tuple(torch.from_numpy(x).to(tr.device) for x in views)

        tr.view_params = view_params
        inner = tr._refresh_labels

        def refresh(epoch, traincase):
            for n in traincase:
                rec["case_dice"][epoch, n] = {r.case_id: r.dice for r in traincase[n]}
            inner(epoch, traincase)

        tr._refresh_labels = refresh
        rec["trainer"] = tr

    PL.DEVICE = device
    result = PL.run_stage("aide", fresh_dir(os.path.join(work, f"aide_{device}")), 2,
                          prepare=prepare, img_size=64, base_width=4)
    tr = rec.pop("trainer")
    return dict(rec, result=result, rows=tr.history, log=tr.refresh_log,
                labels=[tr.train_pipe.labels.get(n) for n in (1, 2)])


def real_ladder_vs_cpu(scratch) -> dict:
    """Phase 17 (g): the ladder's AIDE rung at 64 px (a fixture tree of that
    size), base width 4, f32, TF32 off, lr 1e-6, 2 epochs, on the card and
    on the CPU from the same initial nets and view parameters: the seeded
    pseudo-labels equal voxel for voxel, the same refresh decisions (both
    cases a net, ordered by their dice) each with a margin or on equal
    case dice, the history within 1e-3 and the label-quality track within
    1e-3."""
    import numpy as np
    import torch

    from aide_tpu_torch.data.fixtures import write_reference_chaos
    from aide_tpu_torch.evaluation.case_eval import dice3d_np
    from aide_tpu_torch.experiments import chaos_real_ladder as PL

    work = fresh_dir(os.path.join(scratch, "real_small"))
    tree = write_reference_chaos(os.path.join(work, "reference"), size=64, seed=0)
    saved = {k: getattr(PL, k) for k in ("REF_ROOT", "REF_SPLIT", "DEVICE", "build_cfg")}
    base = PL.build_cfg

    def small_cfg(*args, **kw):
        cfg = base(*args, **kw)
        cfg.model.compute_dtype = "float32"
        cfg.mesh.num_devices = 1
        cfg.optim.lr = 1e-6  # as phase 6 trains
        return cfg

    PL.REF_ROOT, PL.REF_SPLIT, PL.build_cfg = tree["root"], tree["split"], small_cfg
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = real_ladder_small(PL, "cpu", work, None)
        gpu = real_ladder_small(PL, "cuda", work, cpu["weights"])
    finally:
        torch.backends.cudnn.allow_tf32 = True
        for key, value in saved.items():
            setattr(PL, key, value)
    seeded = [bool(np.array_equal(g, c)) for g, c in zip(gpu["seeded"], cpu["seeded"])]
    label_dice = [dice3d_np(g, c) for g, c in zip(gpu["labels"], cpu["labels"])]
    worst = worst_difference(gpu["rows"], cpu["rows"])
    # the order of the two cases decides the logged selection: the CPU's gap
    # between their dice against the largest card-CPU case-dice difference
    # (where that is 0 both sort the same dice, ties included)
    margins = []
    for key in sorted(cpu["case_dice"]):
        ranked = sorted(cpu["case_dice"][key].values())
        margins.append((ranked[1] - ranked[0], max(abs(gpu["case_dice"][key][c] - d)
                                                   for c, d in cpu["case_dice"][key].items())))
    gt, ct = gpu["result"]["label_quality_track"], cpu["result"]["label_quality_track"]
    track = max(abs(a["label_quality"] - b["label_quality"]) for a, b in zip(gt, ct))
    name = "phase 17 (g) the ladder's AIDE rung at 64 px, card vs CPU"
    print(f"{name}: seeded labels equal {seeded}, initial quality "
          f"{gpu['result']['initial_pseudo_quality']} / {cpu['result']['initial_pseudo_quality']}; "
          f"refresh decisions {gpu['log']} / {cpu['log']}, margins (CPU gap, largest card-CPU "
          f"case-dice difference) {json.dumps(margins)}; label quality {json.dumps(gt)} / "
          f"{json.dumps(ct)}; working-label agreement {label_dice}; worst metric difference "
          f"{worst:.3e}", flush=True)
    if not all(seeded) or (gpu["result"]["initial_pseudo_quality"]
                           != cpu["result"]["initial_pseudo_quality"]):
        fail(f"{name}: seeded labels equal {seeded}")
    if gpu["log"] != cpu["log"] or not all(gap > diff or diff == 0 for gap, diff in margins):
        fail(f"{name}: refresh decisions {gpu['log']} vs {cpu['log']}, margins {margins}")
    if len(gt) != len(ct) or len(gt) != 2 or track > 1e-3 or worst > 1e-3:
        fail(f"{name}: label quality {gt} vs {ct}, metrics differ by {worst}")
    return dict(seeded_equal=seeded, margins=margins, label_dice=label_dice,
                label_quality_difference=track, worst_metric_difference=worst)


# ------------------------------- phase 18 -------------------------------


def run_full_circle(cuda_warp, scratch):
    """Phase 18: phase 5's CHAOS point with data.rotation_degree = 360,
    Trainer.run(2) with case evaluation, the checkpoint gate and refresh,
    its steps replayed as a CUDA graph after the first; every step's view
    parameters kept (the step's arguments, which a replay copies into its
    graph), and the tiles of the step's three launches that take the
    kernel's global-tap path counted after the run from the tables the
    step builds of them: the forward table of each modality's views and
    the inverse table of both nets' views."""
    import torch

    from aide_tpu_torch.engine.trainer import Trainer

    cfg = chaos_config()
    cfg.data.rotation_degree = 360.0
    work = os.path.join(scratch, "rot360")
    cfg.checkpoint_dir = fresh_dir(os.path.join(work, "ckpt"))
    cfg.history_dir = fresh_dir(os.path.join(work, "hist"))
    cfg.data.tempmask_folder = "tempmasks"
    task = chaos_task(fresh_dir(os.path.join(work, "chaos")))
    release_device_memory()
    trainer = Trainer(cfg, task)
    trainer.label_cases = set(task.clean_case_ids())
    inner, seen = trainer.train_step, []

    def recording(state, batch, degrees, hflip, *rest):
        seen.append((degrees.reshape(-1).clone(), hflip.reshape(-1).clone()))
        return inner(state, batch, degrees, hflip, *rest)

    trainer.train_step = recording
    try:
        run = drive(trainer, cuda_warp)
    finally:
        trainer.train_step = inner
    print_run("chaos_rot360", run)
    if len(trainer.refresh_log) != 2 * 2:
        fail(f"phase 18: expected 2 refresh decisions an epoch, got {trainer.refresh_log}")
    check_refresh(trainer)
    check_best_exports(trainer, run["best_epochs"])
    check_launches("chaos_rot360", run, 3)
    s = cfg.data.img_size
    tiles = []
    for degrees, hflip in seen:
        forward = cuda_warp.coef_table(degrees, hflip, False)
        inverse = cuda_warp.coef_table(degrees.repeat(2), hflip.repeat(2), True)
        n = cuda_warp.global_tiles(cuda_warp.source_boxes(forward, s, False))
        tiles += [n, n, cuda_warp.global_tiles(cuda_warp.source_boxes(inverse, s, True))]
    turns = float(torch.cat([d for d, _ in seen]).abs().max())
    print(f"chaos_rot360: {len(seen)} steps ({run['replays']} replayed), views up to {turns:.1f} "
          f"degrees, {sum(1 for n in tiles if n)} of their {len(tiles)} launches with tiles on "
          f"the global-tap path, {sum(tiles)} such tiles in all", flush=True)
    if len(seen) != len(run["step_ms"]) or not run["replays"] or turns <= 180 or not any(tiles):
        fail(f"phase 18: {len(seen)} steps seen of {len(run['step_ms'])}, {run['replays']} "
             f"replayed, views up to {turns} degrees, global tiles {tiles}")
    ok = torch.ones(4, device="cuda").add_(1.0).sum().item()
    torch.cuda.synchronize()
    if ok != 8.0:
        fail(f"phase 18: a CUDA operation after the run gave {ok}")
    del trainer
    return dict(run, global_tiles=sum(tiles), launches_with_global_tiles=sum(1 for n in tiles if n))


def run_phases_6_to_11(cuda_warp, scratch, args, chaos, chaos_log):
    """Phases 6-11; returns their runs by path and the kernels line's extra
    entries."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    small_dual_vs_cpu(scratch, "fuseunet", two_modal=True)
    export = small_supervised_vs_cpu(scratch, "unet", two_modal=False)
    small_dual_vs_cpu(scratch, "unet", two_modal=False, resume=export)
    torch.backends.cudnn.allow_tf32 = True

    stamp("phase 6")
    trainer, kidney_sup, kidney_dual = run_kidney(cuda_warp, scratch)
    if args.profile:
        profile_steps("kidney co-teaching", trainer)
    del trainer

    stamp("phase 7")
    presets = run_presets(cuda_warp, scratch)
    stamp("phase 8")

    cli_smoke = run_cli_smoke(cuda_warp, scratch, profile=args.profile)
    cli_chaos = run_cli_chaos(cuda_warp, scratch, profile=args.profile)
    zoo, remat = run_zoo(cuda_warp, scratch)

    stamp("phase 9")
    t10 = [time.perf_counter()]
    chaos_resume = run_resume_chaos(cuda_warp, scratch, chaos, chaos_log)
    t10.append(time.perf_counter())
    kidney_augment = run_augment_supervised(cuda_warp, scratch, kidney_sup)
    t10.append(time.perf_counter())
    cli_first, cli_resume, cli_sgd = run_cli_resume(cuda_warp, scratch)
    t10.append(time.perf_counter())
    print(f"phase 10: {t10[-1] - t10[0]:.2f} s ((a) {t10[1] - t10[0]:.2f}, (b) "
          f"{t10[2] - t10[1]:.2f}, (c) {t10[3] - t10[2]:.2f})", flush=True)

    stamp("phase 10")
    if not presets["chaos_preset"]["exports"]:
        fail("phase 8 (a) wrote no best export to serve")
    t11 = time.perf_counter()
    serving = run_serving(cuda_warp, scratch, presets["chaos_preset"]["exports"][0],
                          kidney_sup["exports"][0])
    print(f"phase 11: {time.perf_counter() - t11:.2f} s", flush=True)
    stamp("phase 11")

    runs = {"chaos_coteach": chaos, "kidney_supervised": kidney_sup,
            "kidney_coteach": kidney_dual, **presets, "cli_smoke": cli_smoke,
            "cli_chaos": cli_chaos, **zoo, "chaos_resume": chaos_resume,
            "kidney_augment": kidney_augment, "cli_resume_first": cli_first,
            "cli_resume": cli_resume, "cli_sgd": cli_sgd}
    extra = {
        "remat_kidney_supervised": remat,
        "resume_chaos": {"epoch2_bit_for_bit": chaos_resume["bitwise"],
                         "epoch2_worst_difference": chaos_resume["worst"],
                         "epoch2_vs_phase5": chaos_resume["phase5"],
                         "epoch1_run_to_run": chaos_resume["spread"],
                         "snapshot_optimizer_bytes": chaos_resume["snapshot_opt_bytes"],
                         "snapshot_state_dict_bytes": chaos_resume["snapshot_net_bytes"]},
        # phase 11 launches no warp: the serving programs' times and sizes
        "serving": serving,
    }
    return runs, extra


def _upsample_pair(cuda_upsample, x, out_dtype, grad) -> float:
    """The kernels' and the plain versions' forward on NHWC ``x`` and
    backward of ``grad``: the largest absolute difference of the two
    directions; fails unless both are bit for bit equal."""
    import torch

    got = cuda_upsample.launch_forward(x, out_dtype)
    ref = cuda_upsample.upsample2x_plain(x, out_dtype)
    g_got = cuda_upsample.launch_backward(grad, x.dtype)
    g_ref = cuda_upsample.upsample2x_grad_plain(grad, x.dtype)
    torch.cuda.synchronize()
    gaps = []
    for what, a, b in (("forward", got, ref), ("backward", g_got, g_ref)):
        gaps.append(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0)
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"upsample {what} {tuple(x.shape)} {x.dtype} -> {out_dtype}: kernel differs "
                 f"from its plain version by {gaps[-1]}")
    return max(gaps)


def check_upsample(cuda_upsample, device) -> float:
    """Phase 19 (a): the kernels bit for bit against their plain versions
    on the card: the edge cases at every pair of input and output dtypes
    the models meet, a base address that allows no vector, and the cells'
    launch shapes in bf16 (and in f32 at batch 8). Returns the largest
    difference measured (0 where all are equal)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(19)
    worst = 0.0
    pairs = [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
             (torch.float16, torch.float16), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float16)]
    for shape in UPSAMPLE_EDGE_SHAPES:
        n, h, w, c = shape
        for din, dout in pairs:
            x = torch.randn(shape, generator=g).to(device, din)
            grad = torch.randn((n, 2 * h, 2 * w, c), generator=g).to(device, dout)
            worst = max(worst, _upsample_pair(cuda_upsample, x, dout, grad))
            # one element past an aligned base: every vector width falls to 1
            off = torch.empty(x.numel() + 1, dtype=din, device=device)[1:].view(shape)
            off.copy_(x)
            if cuda_upsample.vector_width(c, off) != 1 and c > 1:
                fail(f"upsample: an offset base still takes vectors at C={c}")
            worst = max(worst, _upsample_pair(cuda_upsample, off, dout, grad))
    checked = 0
    for path, launches in UPSAMPLE_STEPS.items():
        for shape, _, _ in launches:
            n, s, _, c = shape
            for dtype in (torch.bfloat16,) + ((torch.float32,) if n == 8 else ()):
                x = torch.randn(shape, generator=g).to(device, dtype)
                grad = torch.randn((n, 2 * s, 2 * s, c), generator=g).to(device, dtype)
                worst = max(worst, _upsample_pair(cuda_upsample, x, dtype, grad))
                checked += 1
                del x, grad
            torch.cuda.empty_cache()
    print(f"phase 19 (a): upsample kernels equal their plain versions bit for bit: "
          f"{len(UPSAMPLE_EDGE_SHAPES) * len(pairs) * 2} edge cases, {checked} launch shapes, "
          f"largest difference {worst}", flush=True)
    return worst


def time_upsample(cuda_upsample, device) -> list:
    """Phase 19 (b): each launch shape of UPSAMPLE_STEPS in bf16, cold L2
    (a 64 MB buffer written before each run, outside the events): the
    forward and backward kernels, their plain versions, and ATen's NHWC
    kernels (``F.interpolate`` and its backward on channels_last tensors)
    in bf16 with autocast off, the library yardstick, and in f32, as
    autocast ran them; beside the bytes-over-bandwidth bound of the bf16
    kernels. At batch 8, where a step runs the backward, each bf16
    backward's largest difference from the exact (f64) gradient, and the
    bf16 library forward's elements that differ from the kernel's."""
    import torch
    import torch.nn.functional as F

    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def flush():
        scratch.fill_(1.0)

    shapes = sorted({shape for launches in UPSAMPLE_STEPS.values() for shape, _, _ in launches},
                    key=lambda t: (t[1], t[0]))
    g = torch.Generator(device="cpu").manual_seed(23)
    rows = []
    for shape in shapes:
        n, s, _, c = shape
        x = torch.randn(shape, generator=g).to(device, torch.bfloat16)
        grad = torch.randn((n, 2 * s, 2 * s, c), generator=g).to(device, torch.bfloat16)
        bf = torch.bfloat16
        fwd = time_cuda(lambda: cuda_upsample.launch_forward(x, bf), flush=flush)
        bwd = time_cuda(lambda: cuda_upsample.launch_backward(grad, bf), flush=flush)
        p_fwd = time_cuda(lambda: cuda_upsample.upsample2x_plain(x, bf), runs=10, warmup=2)
        p_bwd = time_cuda(lambda: cuda_upsample.upsample2x_grad_plain(grad, bf), runs=10,
                          warmup=2)
        # ATen's kernels on the NCHW channels_last views: bf16, then f32 copies
        xb, gb = x.permute(0, 3, 1, 2), grad.permute(0, 3, 1, 2)
        xf, gf = xb.float(), gb.float()

        def lib_fwd(t):
            return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)

        def lib_bwd(t):
            return torch.ops.aten.upsample_bilinear2d_backward(
                t, [2 * s, 2 * s], [n, c, s, s], False, 2.0, 2.0)

        lib = {f"library{tag}_{d}ms": time_cuda(lambda: fn(t), flush=flush)
               for tag, a, b in (("", xb, gb), ("_f32", xf, gf))
               for d, fn, t in (("", lib_fwd, a), ("bwd_", lib_bwd, b))}
        nbytes = cuda_upsample.bytes_moved(shape, 2, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        f32_bytes = cuda_upsample.bytes_moved(shape, 4, 4)
        row = dict(shape=shape, dtype="bfloat16", bytes=nbytes, bound_ms=bound,
                   ms=fwd, bwd_ms=bwd, plain_ms=p_fwd, plain_bwd_ms=p_bwd, **lib,
                   library_f32_bytes=f32_bytes, vector=cuda_upsample.vector_width(c, x))
        if n == 8:
            exact = cuda_upsample.upsample2x_grad_plain(grad.double(), torch.float64)
            row["bwd_err"] = float((cuda_upsample.launch_backward(grad, bf).double()
                                    - exact).abs().max())
            row["library_bwd_err"] = float((lib_bwd(gb).permute(0, 2, 3, 1).double()
                                            - exact).abs().max())
            row["library_fwd_mismatches"] = int(
                (lib_fwd(xb).permute(0, 2, 3, 1) != cuda_upsample.launch_forward(x, bf)).sum())
            del exact
        print(f"phase 19 (b) upsample {shape} bf16: forward {fwd:.4f} ms ({bound / fwd:.1%} of "
              f"the {bound * 1e3:.1f} us bound), backward {bwd:.4f} ms ({bound / bwd:.1%}); "
              f"plain {p_fwd:.4f} / {p_bwd:.4f} ms; library bf16 {lib['library_ms']:.4f} / "
              f"{lib['library_bwd_ms']:.4f} ms, f32 {lib['library_f32_ms']:.4f} / "
              f"{lib['library_f32_bwd_ms']:.4f} ms ({f32_bytes / HBM_BYTES_PER_S * 1e3 / lib['library_f32_ms']:.1%} "
              f"of its own f32 bound forward)"
              + (f"; backward's largest error against f64: kernel {row['bwd_err']:.3g}, library "
                 f"bf16 {row['library_bwd_err']:.3g}; library bf16 forward elements unlike the "
                 f"kernel's {row['library_fwd_mismatches']}" if n == 8 else ""), flush=True)
        rows.append(row)
        del x, grad, xb, gb, xf, gf
        torch.cuda.empty_cache()
    del scratch
    return rows


def upsample_in_replayed_step(device) -> dict:
    """Phase 19 (c): the kidney cell's co-teaching step (a UNet-64 pair,
    512 px, batch 8, 4 eval-mode views, bf16) replayed as a CUDA graph: the
    upsample kernels the host called in an eager step, and under
    torch.profiler the kernels the card ran in 2 replayed steps: as many
    upsample2x kernels a step, and no ATen upsample_bilinear2d kernel."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aide_tpu_torch.core import trace
    from aide_tpu_torch.core.config import TrainConfig
    from aide_tpu_torch.engine import steps
    from aide_tpu_torch.engine.state import DualTrainState
    from aide_tpu_torch.engine.trainer import init_net
    from aide_tpu_torch.ops import tta
    from aide_tpu_torch.ops.schedules import make_optimizer

    size, b, views = 512, 8, 4
    cfg = TrainConfig()
    cfg.model.name, cfg.model.base_width, cfg.model.compute_dtype = "unet", 64, "bfloat16"
    cfg.data.img_size, cfg.data.batch_size, cfg.data.num_tta_views = size, b, views
    cfg.coteach.tta_bn, cfg.coteach.sharpen_mode = "running", "pow_inv_t"
    nets = [init_net(cfg.model, seed).to(device, memory_format=torch.channels_last)
            for seed in (0, 1)]
    opt = make_optimizer([p for net in nets for p in net.parameters()], cfg.optim, 1, 20)
    state = DualTrainState(*nets, opt)
    step = steps.make_coteach_train_step(False, cfg)
    rng = np.random.default_rng(19)
    yy, xx = np.mgrid[0:size, 0:size]
    batch = {"image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
             "scale": rng.uniform(0.01, 0.03, (b, 3)).astype(np.float32),
             "fill": rng.uniform(-2.5, -0.5, (b, 3)).astype(np.float32)}
    for t in ("target1", "target2"):
        cy, cx = rng.uniform(0.25, 0.75, 2) * size
        r = rng.uniform(0.1, 0.3) * size
        batch[t] = np.broadcast_to(((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int64),
                                   (b, size, size)).copy()
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    degrees, hflip = tta.sample_view_params(torch.Generator().manual_seed(19), views, b, 60.0,
                                            0.5)
    degrees, hflip = degrees.to(device), hflip.to(device)
    per_eager = []
    for _ in range(3):  # 2 eager steps and the capture
        before = trace.totals()
        step(state, batch, degrees, hflip, 0.25)
        torch.cuda.synchronize()
        per_eager.append(trace.delta(before).get("upsample.launches", 0))
    before = trace.totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, batch, degrees, hflip, 0.25)
        torch.cuda.synchronize()
    spent = trace.delta(before)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    ran = sum("upsample2x_" in name for name in names)
    aten = sum("upsample_bilinear2d" in name for name in names)
    out = dict(host_launches_eager_step=per_eager[0], host_launches_capture=per_eager[2],
               replays=spent.get("train.graph_replays", 0),
               host_launches_replayed=spent.get("upsample.launches", 0),
               upsample2x_kernels_replayed=ran, aten_upsample_kernels_replayed=aten)
    print("phase 19 (c): the kidney step replayed: " + json.dumps(out), flush=True)
    if out["replays"] != 2 or out["host_launches_replayed"] != 0:
        fail(f"phase 19 (c): expected 2 replays and no host-called launch: {out}")
    want = upsample_step_launches("kidney_coteach")
    if per_eager != [want] * 3 or ran != 2 * want or aten:
        fail(f"phase 19 (c): the eager steps and the capture must each call {want} upsample2x "
             f"launches, and a replayed kidney step run as many and no ATen upsample: {out}")
    return out


def run_upsample(device) -> dict:
    """Phase 19: the decoders' upsample kernels, built, checked and timed
    alone (UPSAMPLE_STEPS), and counted in a replayed kidney step. Returns
    the kernel's entry of the {"kernels": [...]} line. Runs alone too, and
    then prints that line: python3 -c "import chip_smoke;
    chip_smoke.run_upsample(None)"."""
    import torch

    alone = device is None
    if alone:
        if not torch.cuda.is_available():
            fail("phase 19 needs a CUDA device")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        device = torch.device("cuda")
        print(smi_line(), flush=True)
    from aide_tpu_torch.ops import cuda_upsample

    t0 = time.perf_counter()
    cuda_upsample.build(verbose=True)
    print(f"phase 19: upsample build {time.perf_counter() - t0:.2f} s", flush=True)
    worst = check_upsample(cuda_upsample, device)
    rows = time_upsample(cuda_upsample, device)
    by_shape = {r["shape"]: r for r in rows}
    by_path = {}
    for path, launches in UPSAMPLE_STEPS.items():
        fwd_keys = ("ms", "plain_ms", "library_ms", "library_f32_ms")
        bwd_keys = ("bwd_ms", "plain_bwd_ms", "library_bwd_ms", "library_f32_bwd_ms")
        entry = {k: 0.0 for k in fwd_keys + bwd_keys + ("bound_ms", "bwd_bound_ms")}
        for shape, fwd_n, bwd_n in launches:
            r = by_shape[shape]
            for k in fwd_keys:
                entry[k] += fwd_n * r[k]
            for k in bwd_keys:
                entry[k] += bwd_n * r[k]
            entry["bound_ms"] += fwd_n * r["bound_ms"]
            entry["bwd_bound_ms"] += bwd_n * r["bound_ms"]
        entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
        entry["bwd_share_of_bound"] = (entry["bwd_bound_ms"] / entry["bwd_ms"]
                                       if entry["bwd_ms"] else None)
        by_path[path] = entry
        print(f"phase 19 (b) {path}, a step: forward {entry['ms']:.3f} ms "
              f"({entry['share_of_bound']:.1%} of {entry['bound_ms']:.3f}), backward "
              f"{entry['bwd_ms']:.3f} ms, plain {entry['plain_ms']:.3f} / "
              f"{entry['plain_bwd_ms']:.3f}, library bf16 {entry['library_ms']:.3f} / "
              f"{entry['library_bwd_ms']:.3f}, library f32 {entry['library_f32_ms']:.3f} / "
              f"{entry['library_f32_bwd_ms']:.3f}", flush=True)
    replay = upsample_in_replayed_step(device)
    kidney = by_path["kidney_coteach"]
    entry = {
        "name": "upsample2x",
        "route": "cuda",
        "source": "aide_tpu_torch/csrc/upsample2x.cu",
        "replaces": None,  # jax.image.resize is a library call, no Pallas kernel
        "max_abs_err": worst,
        # one kidney co-teaching step's forward launches, each timed cold
        "ms": kidney["ms"],
        "plain_ms": kidney["plain_ms"],
        "bound_ms": kidney["bound_ms"],
        "bound_by": "bytes",
        # ATen's kernels in bf16 with autocast off; in f32 as autocast ran them
        "library_ms": kidney["library_ms"],
        "library_f32_ms": kidney["library_f32_ms"],
        "by_path": by_path,
        "per_launch": rows,
        "replayed_kidney_step": replay,
    }
    if alone:
        print(json.dumps({"kernels": [entry]}), flush=True)
    return entry


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="a torch.profiler breakdown of a few more co-teaching steps "
                             "after phases 5, 7, 9 (a), (b) and 12")
    parser.add_argument("--baseline", metavar="FILE.cu", action="append", default=[],
                        help="another version of csrc/warp_rotate_flip.cu to time in phase 4 "
                             "(repeatable)")
    parser.add_argument("--data-axis", action="store_true",
                        help="phases 1-5 and 12-14 only: the data, net and space axes and what "
                             "they are held to (for a machine with several cards)")
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

    stamp("phases 1-4")
    trainer, chaos = run_slice(cuda_warp, scratch)
    chaos_log = list(trainer.refresh_log)
    if args.profile:
        profile_steps("chaos co-teaching", trainer)
    replay = run_graph_vs_eager(trainer)
    del trainer

    stamp("phase 5")
    runs = {"chaos_coteach": chaos}
    extra = {}
    if not args.data_axis:
        runs, extra = run_phases_6_to_11(cuda_warp, scratch, args, chaos, chaos_log)

    t12 = time.perf_counter()
    data_axis = run_data_axis(scratch, chaos, chaos_log, args.profile)
    print(f"phase 12: {time.perf_counter() - t12:.2f} s", flush=True)
    stamp("phase 12")
    world = data_axis["world"]
    SAME_SHAPES["data_axis"] = (DATA_AXIS_SHAPES[world],)
    t13 = time.perf_counter()
    net_axis = run_net_axis(scratch, chaos, chaos_log, data_axis, args.profile)
    print(f"phase 13: {time.perf_counter() - t13:.2f} s", flush=True)
    stamp("phase 13")
    net_runs = {f"net_axis_{w}": run for w, run in net_axis.items()}
    t14 = time.perf_counter()
    space_axis, kidney_space = run_space_axis(scratch, chaos, chaos_log, args.profile)
    print(f"phase 14: {time.perf_counter() - t14:.2f} s", flush=True)
    stamp("phase 14")
    space_runs = {f"space_axis_{w}": run for w, run in space_axis.items()}
    bench, ladder, real, upsample = {}, None, {}, None
    if not args.data_axis:
        t15 = time.perf_counter()
        bench = run_bench(root, scratch)
        print(f"phase 15: {time.perf_counter() - t15:.2f} s", flush=True)
        stamp("phase 15")
        t16 = time.perf_counter()
        ladder = run_ladder(root, scratch)
        ladder_small = ladder_vs_cpu(scratch)
        print(f"phase 16: {time.perf_counter() - t16:.2f} s", flush=True)
        stamp("phase 16")
        t17 = time.perf_counter()
        real = run_real_programs(root, scratch)
        real_small = real_ladder_vs_cpu(scratch)
        print(f"phase 17: {time.perf_counter() - t17:.2f} s", flush=True)
        stamp("phase 17")
        t18 = time.perf_counter()
        runs["chaos_rot360"] = run_full_circle(cuda_warp, scratch)
        print(f"phase 18: {time.perf_counter() - t18:.2f} s", flush=True)
        stamp("phase 18")
        upsample = run_upsample(device)
        stamp("phase 19")

    by_path = {}
    for path, run in {**runs, "data_axis": data_axis, **net_runs, **space_runs}.items():
        launched = [r for r in rows if r["path"] in SAME_SHAPES.get(path, (path,))]
        by_path[path] = {
            # the host's calls; a replayed step's kernels launch with its graph
            "launches": run["launches"],
            "steps": len(run["step_ms"]),
            "replayed_steps": run["replays"],
            # one step's launches, each timed with a cold L2
            "kernel_ms_per_step": sum(r["per_step"] * r["ms"] for r in launched),
            "plain_ms_per_step": sum(r["per_step"] * r["plain_ms"] for r in launched),
            "bound_ms_per_step": sum(r["per_step"] * r["bound_ms"] for r in launched),
            "step_ms": run["steady"],
            "first_step_ms": run["step_ms"][0],
            "max_memory_allocated": run["peak"],
            **({"decode_s": run["decode_s"]} if "decode_s" in run else {}),
            **({k: run[k] for k in ("global_tiles", "launches_with_global_tiles")}
               if "global_tiles" in run else {}),
        }
    ranks = data_axis["ranks"]
    by_path["data_axis"].update({
        "world": world, "cards": data_axis["cards"],
        "launches_by_rank": [ranks[r]["launches"] for r in sorted(ranks)],
        "step_ms_by_rank": [ranks[r]["steady"] for r in sorted(ranks)],
        "max_memory_allocated_by_rank": [ranks[r]["peak"] for r in sorted(ranks)],
        "collectives_per_step": sorted(set(data_axis["collectives_per_step"])),
        "grad_allreduce_bytes": data_axis["allreduce_bytes"],
        "grad_allreduce_ms": data_axis["allreduce_ms"],
        "grad_sync_ms": data_axis["sync_ms"],
        "step_ms_world1": chaos["steady"],
    })
    for path, run in net_runs.items():
        net_ranks = run["ranks"]
        by_path[path].update({
            "world": run["world"], "net_size": 2, "data": run["world"] // 2,
            "launches_by_rank": [net_ranks[r]["launches"] for r in sorted(net_ranks)],
            "step_ms_by_rank": [net_ranks[r]["steady"] for r in sorted(net_ranks)],
            "max_memory_allocated_by_rank": [net_ranks[r]["peak"] for r in sorted(net_ranks)],
            "collectives_per_step": sorted(set(run["collectives_per_step"])),
            "collective_bytes_per_step": sorted(set(run["collective_bytes_per_step"])),
            "pair_exchange_bytes": run["exchange_bytes"],
            "pair_exchange_ms": run["exchange_ms"],
            **({"grad_allreduce_bytes": run["allreduce_bytes"],
                "grad_allreduce_ms": run["allreduce_ms"], "grad_sync_ms": run["sync_ms"]}
               if "allreduce_ms" in run else {}),
            "step_ms_world1": chaos["steady"],
            "step_ms_data_axis": data_axis["steady"],
        })
    for path, run in space_runs.items():
        space_ranks = run["ranks"]
        by_path[path].update({
            "world": run["world"], "space": 2, "net_size": run["net_size"],
            "launches_by_rank": [space_ranks[r]["launches"] for r in sorted(space_ranks)],
            "step_ms_by_rank": [space_ranks[r]["steady"] for r in sorted(space_ranks)],
            "max_memory_allocated_by_rank": [space_ranks[r]["peak"] for r in sorted(space_ranks)],
            "collectives_by_kind_per_step": run["by_kind"],
            "halo_ms_per_step": [space_ranks[r]["halo_ms"] for r in sorted(space_ranks)],
            "step_ms_world1": chaos["steady"],
        })
    for row in bench.values():
        if "warp_launches_timed" not in row:
            continue  # the eval-volume line: no train step
        launched = [r for r in rows if r["path"] in SAME_SHAPES.get(row["path"], (row["path"],))]
        by_path[row["path"]] = {
            "launches_per_step": row["warp_launches_per_step"],
            "replayed_steps": row["graph_replays_timed"],
            **({"launches_epoch": row["warp_launches_epoch"],
                "replayed_steps_epoch": row["graph_replays_epoch"]}
               if "warp_launches_epoch" in row else {}),
            "kernel_ms_per_step": sum(r["per_step"] * r["ms"] for r in launched),
            "plain_ms_per_step": sum(r["per_step"] * r["plain_ms"] for r in launched),
            "bound_ms_per_step": sum(r["per_step"] * r["bound_ms"] for r in launched),
            "step_ms": row["train_step_seconds"] * 1e3,
            "max_memory_allocated": row["peak_memory_bytes"],
        }
    if bench:
        extra["bench"] = {sub: {k: v for k, v in row.items() if k != "history"}
                          for sub, row in bench.items()}
    if ladder is not None:
        aide = ladder["runs"]["aide"]
        launched = [r for r in rows if r["path"] == "ladder_aide"]
        by_path["ladder_aide"] = {
            "launches": aide["warp_launches"],
            "steps": aide["train_steps"],
            "replayed_steps": aide["graph_replays"],
            "kernel_ms_per_step": sum(r["per_step"] * r["ms"] for r in launched),
            "plain_ms_per_step": sum(r["per_step"] * r["plain_ms"] for r in launched),
            "bound_ms_per_step": sum(r["per_step"] * r["bound_ms"] for r in launched),
            "epoch_s": ladder["epoch_s"]["aide"],
        }
        extra["ladder"] = {
            "seconds": ladder["seconds"], "summary": ladder["summary"],
            "stages": {stage: {k: r[k] for k in ("seconds", "train_steps", "warp_launches",
                                                 "graph_replays", "best_testcase_dice")}
                       for stage, r in ladder["runs"].items()},
            "epoch_s": ladder["epoch_s"], "card_vs_cpu": ladder_small}
    for path, run in real.items():
        # the AIDE rungs launch at the CHAOS preset's shapes, the supervised runs not at all
        launched = [r for r in rows if run["warp_launches"] and r["path"] in SAME_SHAPES[path]]
        by_path[path] = {
            "launches": run["warp_launches"],
            "steps": run["train_steps"],
            "replayed_steps": run["graph_replays"],
            "kernel_ms_per_step": sum(r["per_step"] * r["ms"] for r in launched),
            "plain_ms_per_step": sum(r["per_step"] * r["plain_ms"] for r in launched),
            "bound_ms_per_step": sum(r["per_step"] * r["bound_ms"] for r in launched),
            "epoch_s": run["epoch_s"],
        }
    if real:
        extra["real_programs"] = {
            path: {k: run[k] for k in ("command_s", "seconds", "epoch_s", "train_steps",
                                       "warp_launches", "graph_replays", "best_case10_dice")}
            for path, run in real.items()}
        extra["real_programs"]["card_vs_cpu"] = real_small
    if kidney_space is not None:
        extra["kidney_space_2"] = {
            "one_card": {k: kidney_space["one"][k] for k in ("metrics", "steady", "peak")},
            "ranks": {r: {k: v[k] for k in ("metrics", "steady", "peak")}
                      for r, v in kidney_space["ranks"].items()}}
    chaos_step = by_path["chaos_coteach"]
    launches = {path: run["launches"] for path, run in runs.items()}
    launches.update({f"data_axis_rank{r}": ranks[r]["launches"] for r in sorted(ranks)})
    for path, run in {**net_runs, **space_runs}.items():
        launches.update({f"{path}_rank{r}": n["launches"] for r, n in sorted(run["ranks"].items())})
    # the bench's own processes: the timed epoch's launches at (a), the
    # timed bare steps' at (c) and (d), as each process counted them
    launches.update({row["path"]: row.get("warp_launches_epoch", row["warp_launches_timed"])
                     for row in bench.values() if "warp_launches_timed" in row})
    # the ladder's process: its AIDE stage's launches (its other stages' 0)
    if ladder is not None:
        launches["ladder_aide"] = ladder["runs"]["aide"]["warp_launches"]
    # the real-data programs' processes: each run's launches (0 in the
    # supervised ones)
    launches.update({path: run["warp_launches"] for path, run in real.items()})
    if upsample is not None:
        # the upsample kernels' host calls in the train steps ``watched``
        # saw, which check_launches held to upsample_per_step in each eager
        # or captured step and to 0 in each replay
        up = {path: run["step_upsample"] for path, run in runs.items()}
        up.update({f"data_axis_rank{r}": ranks[r]["step_upsample"] for r in sorted(ranks)})
        for path, run in {**net_runs, **space_runs}.items():
            up.update({f"{path}_rank{r}": n["step_upsample"] for r, n in sorted(run["ranks"].items())})
        upsample.update(launches=sum(sum(v) for v in up.values()),
                        launches_by_path={path: sum(v) for path, v in up.items()},
                        launches_per_step_by_path={path: sorted(set(v)) for path, v in up.items()})
    kernels = [{
        "name": "warp_rotate_flip",
        "route": "cuda",
        "source": "aide_tpu_torch/csrc/warp_rotate_flip.cu",
        "replaces": "aide_tpu/ops/pallas_warp.py:77",
        # the host's calls of the kernel, counted where it is launched; the
        # steps replayed as a CUDA graph launch theirs with the graph:
        # replayed_steps by path, and phase 5 (b) counts their kernels in
        # a device trace (replay_vs_eager)
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "replayed_steps_by_path": {path: entry["replayed_steps"]
                                   for path, entry in by_path.items() if "replayed_steps" in entry},
        "replayed_warp_kernels_per_step": replay["replayed_warp_kernels_per_step"],
        "replay_vs_eager": replay,
        "max_abs_err": max([worst] + [r["max_abs_err"] for r in rows]
                           + [ranks[r]["warp_err"] for r in ranks]
                           + [n["warp_err"] for run in net_runs.values()
                              for n in run["ranks"].values()]),
        # one CHAOS co-teaching step: two forward launches and one inverse
        # launch, each timed with a cold L2 (by_path has the kidney step,
        # per_launch the warm times)
        "ms": chaos_step["kernel_ms_per_step"],
        "plain_ms": chaos_step["plain_ms_per_step"],
        "bound_ms": chaos_step["bound_ms_per_step"],
        "bound_us": chaos_step["bound_ms_per_step"] * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "per_launch": rows,
        "by_path": by_path,
        "step_ms": chaos["steady"],
        "max_memory_allocated": chaos["peak"],
        **extra,
    }] + ([upsample] if upsample is not None else [])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
