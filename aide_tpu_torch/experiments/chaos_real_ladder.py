"""Real-data CHAOS pseudo-label ladder on the shipped cases.

The counterpart of the JAX package's ``experiments/chaos_real_ladder.py``,
with the same flags, defaults, JSON lines and keys. The reference's flagship
artifact is the CHAOS 30cases/1labeled ladder
(train_files/examplesegmentationresults): for validation case 10 its golden
CSVs record

    pretrain (1 labeled case)              Dice 0.479
    naive on pseudo-labels (30 cases)      Dice 0.547
    AIDE co-teaching + refresh             Dice 0.831

The reference ships DICOM and ground truth for exactly two cases, 37 (the
one labeled training case) and 10 (validation), plus the bootstrap
pseudo-labels its pretrain generated
(inputs_chaos/All_Sets/generated_masks/pretrain_1case_fuseunet_r1/). That
is enough to run the ladder's two upper rungs for case 10:

- naive: supervised FuseUNet on case 37 (clean ground truth) and case 10
  labeled by the shipped pseudo-labels, the golden 0.547 rung;
- aide: the flagship dual-net co-teaching protocol on the same data: case
  37 exempt (labeled), case 10's working labels seeded from the shipped
  pseudo-labels and refreshed; a label-quality oracle scores the working
  labels against case 10's ground truth after every refresh (the ground
  truth is never trained on in this stage), the golden 0.831 rung.

The pretrain rung is ``aide_tpu_torch.experiments.chaos_real_1case``. The
reference trained these rungs with 29 pseudo-labeled cases and only case
10's ship, so the claim under test is the ordering (aide > naive) and the
oracle improving, not the golden values.

Each stage prints its initial pseudo-label quality, one line a refresh
(aide) and its JSON line: the JAX program's keys plus ``seconds``,
``train_steps``, ``warp_launches`` (the TTA warp kernel's host-called
launches in the stage's ``Trainer.run``: 3 an eager or captured step in
the aide rung, 0 in the naive one), ``graph_replays`` (the steps replayed
as a CUDA graph, whose warp kernels launch with it) and ``checkpoint``
(the best epoch's export, net 1 of the pair in the aide rung); the last
line adds the card's name and power limit.
``model.packed`` and ``model.packed_block_barrier`` are set as the JAX
program sets them and change nothing: the port runs the plain network.

Usage: python -m aide_tpu_torch.experiments.chaos_real_ladder [--epochs N]
       [--stage naive|aide|both] [--resume CKPT] [--reference DIR]
       [--workdir DIR] [--out F] [--device cpu]
It runs on the first CUDA card and raises without one, unless ``--device``
names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from aide_tpu_torch.bench import device_info
from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.data.io import png
from aide_tpu_torch.data.tasks.base import resize_mask
from aide_tpu_torch.data.tasks.chaos import FOREGROUND_VALUE
from aide_tpu_torch.engine import checkpoint as ckpt_mod
from aide_tpu_torch.engine import trainer as trainer_mod
from aide_tpu_torch.evaluation.case_eval import dice3d_np
from aide_tpu_torch.experiments import reference

REF_ROOT, REF_SPLIT = reference.chaos_paths(reference.REFERENCE)
PSEUDO_DIR = "generated_masks/pretrain_1case_fuseunet_r1"
GOLDEN = {"pretrain": 0.479, "naive": 0.547, "aide": 0.831}
# the device every stage runs on: None is the first CUDA card (and raises
# without one), "cpu" the host
DEVICE = None


def make_csvs(workdir: str):
    """Train CSV = case 37 (clean ground truth) + case 10 (clean ground
    truth: the column keeps pipe.targets honest for the oracle; case 10's
    training labels are swapped to the shipped pseudo-labels in memory)."""
    os.makedirs(workdir, exist_ok=True)
    csv37 = os.path.join(REF_SPLIT, "splitimages_cleanlabel/train_data_1cases.csv")
    header, rows37 = reference.read_table(csv37)
    reference.require_rows(csv37, header, rows37, "37")
    val_csv = os.path.join(REF_SPLIT, "splitimages_cleanlabel/val_data_10cases.csv")
    val_header, val_rows = reference.read_table(val_csv)
    rows10 = reference.require_rows(val_csv, val_header, val_rows, "10")
    if header != val_header:
        raise ValueError(f"{csv37!r} and {val_csv!r} have other columns")

    train_out = os.path.join(workdir, "train_37_10.csv")
    reference.write_table(train_out, header, rows37 + rows10)
    val_out = os.path.join(workdir, "val_case10.csv")
    reference.write_table(val_out, header, rows10)

    tc = reference.write_cases(os.path.join(workdir, "traincases.csv"), [37, 10])
    vc = reference.write_cases(os.path.join(workdir, "valcases.csv"), [10])
    lc = reference.write_cases(os.path.join(workdir, "labelcases.csv"), [37])
    return train_out, val_out, tc, vc, lc


def build_cfg(stage: str, workdir: str, epochs: int,
              img_size: int = 256, base_width: int = 0, batch: int = 4,
              resume: str = "") -> TrainConfig:
    """``img_size``/``base_width``/``batch`` default to the flagship
    operating point; a smoke run shrinks them."""
    train_csv, val_csv, tc, vc, lc = make_csvs(workdir)
    cfg = TrainConfig()
    # flagship trainchaos_proposed_30cases1labeled defaults: fuseunet, bs 4,
    # 256 px, Adam(amsgrad) 1e-4 + StepLR, warmup 20, consistency weight 10
    cfg.model = ModelConfig(
        name="fuseunet", compute_dtype="bfloat16", packed=True,
        base_width=base_width, packed_block_barrier=True,
    )
    cfg.data.task = "chaos"
    cfg.data.variant = "proposed" if stage == "aide" else "comparison"
    cfg.data.root = REF_ROOT
    cfg.data.train_csv = train_csv
    cfg.data.test_csv = val_csv
    cfg.data.traincase_csv = tc
    cfg.data.testcase_csv = vc
    if stage == "aide":
        cfg.data.labelcase_csv = lc
        # absolute: keeps the disk mirror out of the read-only reference
        # tree (ChaosTask joins it onto data.root otherwise)
        cfg.data.tempmask_folder = os.path.join(workdir, f"tempmask_{stage}")
        # the reference refreshes the worst 25% of 30 cases (7 an epoch);
        # with 2 train cases int(0.25 * 2) = 0 would disable refresh, so
        # cover the whole 1-case unlabeled pool (case 37 stays exempt)
        cfg.coteach.update_percent = 1.0
    cfg.data.img_size = img_size
    cfg.data.decode_cache_dir = os.path.join(workdir, "decode_cache")
    cfg.data.batch_size = batch
    cfg.data.eval_batch_size = max(batch, 8)
    cfg.num_epochs = epochs
    cfg.repetition = 3
    # an optional warm start of the aide rung's dual nets (the prostate
    # transfer protocol): model skill near the bootstrap label quality
    # instead of a random init
    if resume and stage == "aide":
        cfg.resume_file = resume
    cfg.checkpoint_dir = os.path.join(workdir, f"ckpt_{stage}")
    cfg.history_dir = os.path.join(workdir, f"hist_{stage}")
    return cfg


def shipped_pseudo_volume(pipe, case: str) -> np.ndarray:
    """The reference pretrain's pseudo-labels for ``case``, in the order of
    ``pipe.case_indices(case)``, decoded and resized exactly as the task
    decodes ground-truth masks (binary at liver = 63)."""
    rows = []
    for i in pipe.case_indices(case):
        spec = pipe.specs[i]
        name = os.path.basename(spec.mask_path)
        path = os.path.join(REF_ROOT, PSEUDO_DIR, case, name)
        mask = (png.read_mask(path) == FOREGROUND_VALUE).astype(np.uint8)
        rows.append(resize_mask(mask, pipe.img_size))
    return np.stack(rows)


def dice(a, b) -> float:
    return round(dice3d_np(a, b), 4)


def run_stage(stage: str, workdir: str, epochs: int, prepare=None, **cfg_kw) -> dict:
    """One rung. ``prepare(trainer, stage)``, when given, is called just
    before ``trainer.run`` (the tests carry another package's initial
    weights and view parameters in through it)."""
    warm = bool(cfg_kw.get("resume"))
    cfg = build_cfg(stage, workdir, epochs, **cfg_kw)
    t0 = time.time()
    trainer = trainer_mod.Trainer(cfg, device=DEVICE)
    pipe = trainer.train_pipe
    idxs = pipe.case_indices("10")
    pseudo = shipped_pseudo_volume(pipe, "10")
    initial_quality = dice(pseudo, pipe.targets[idxs])
    print(json.dumps({"stage": stage, "initial_pseudo_quality": initial_quality}), flush=True)

    quality_track = []
    if stage == "aide":
        # seed case 10's working labels with the shipped pseudo-labels;
        # pipe.targets stay the ground truth (the oracle; never trained on)
        for net in (1, 2):
            pipe.labels.refresh_case(net, idxs, pseudo)
        # the changed rows into the device copy (each rank's block of a
        # sharded cache); without one it only clears the record
        pipe.sync_labels_to_device()
        # the measured bootstrap quality (case 10's ground truth ships: the
        # practitioner's labeled-validation reading) feeds the guardrail's
        # cliff/transition/clear verdict, and the trainer measures no probe
        trainer.engagement_probe = {
            "bootstrap_skill1": initial_quality,
            "bootstrap_skill2": initial_quality,
        }

        def on_refresh(epoch):
            g = pipe.targets[idxs]
            q = round(sum(dice(pipe.labels.get(net)[idxs], g) for net in (1, 2)) / 2, 4)
            quality_track.append({"epoch": epoch + 1, "label_quality": q})
            print(json.dumps(quality_track[-1]), flush=True)

        trainer.on_refresh = on_refresh
    else:
        # naive: train directly on the pseudo-labels (the golden 0.547 rung)
        pipe.targets[idxs] = pseudo
        if pipe._device_data is not None or pipe._sharded is not None:
            # the targets are uploaded whole: again, in the trainer's placement
            pipe.to_device(trainer.device)

    if prepare is not None:
        prepare(trainer, stage)
    launched = trace.totals()
    history = trainer.run(epochs)
    spent = trace.delta(launched)
    launches, replays = spent.get("warp.launches", 0), spent.get("train.graph_replays", 0)
    best = max(
        max(r.get("testcase_dice1", 0.0), r.get("testcase_dice2", 0.0)) for r in history
    )
    last = history[-1]
    seconds = time.time() - t0
    return {
        "stage": stage,
        "warm_start": warm,
        "epochs": epochs,
        "initial_pseudo_quality": initial_quality,
        **({"label_quality_track": quality_track} if stage == "aide" else {}),
        # the oracle-free run-time engagement verdict (end of warmup ramp)
        **(
            {"engagement": trainer.engagement}
            if stage == "aide" and trainer.engagement is not None
            else {}
        ),
        **(
            {"engagement_probe": trainer.engagement_probe}
            if stage == "aide" and trainer.engagement_probe is not None
            else {}
        ),
        "final_case10_dice": max(
            last.get("testcase_dice1", 0.0), last.get("testcase_dice2", 0.0)
        ),
        "best_case10_dice": best,
        "golden_reference_case10_dice": GOLDEN[stage],
        "minutes": round(seconds / 60, 1),
        "seconds": seconds,
        "train_steps": len(history) * pipe.steps_per_epoch(cfg.data.batch_size),
        "warp_launches": launches,
        "graph_replays": replays,
        "checkpoint": ckpt_mod.best_net_path(
            cfg.checkpoint_dir, cfg.experiment_name, 1 if stage == "aide" else None
        ),
    }


def main(argv=None) -> int:
    global REF_ROOT, REF_SPLIT, DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--stage", default="both", choices=("naive", "aide", "both"))
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "chaos_real_ladder"))
    ap.add_argument("--out", default="")
    ap.add_argument("--resume", default="",
                    help="warm-start the aide rung's dual nets from this "
                         "checkpoint (prostate transfer protocol)")
    reference.add_arguments(ap)
    args = ap.parse_args(argv)
    DEVICE = trainer_mod.resolve_device(args.device)
    REF_ROOT, REF_SPLIT = reference.chaos_paths(args.reference)

    stages = ("naive", "aide") if args.stage == "both" else (args.stage,)
    results = {"golden": GOLDEN, "pretrain_rung": "chaos_real_1case_r2.json (0.636 best)"}
    for stage in stages:
        results[stage] = run_stage(stage, args.workdir, args.epochs, resume=args.resume)
        print(json.dumps(results[stage]), flush=True)
    if "naive" in results and "aide" in results:
        results["aide_over_naive"] = round(
            results["aide"]["best_case10_dice"] - results["naive"]["best_case10_dice"], 4
        )
    # the card's name and power limit beside the minutes
    results.update(device_info(DEVICE))
    print(json.dumps({k: v for k, v in results.items() if k != "golden"}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
