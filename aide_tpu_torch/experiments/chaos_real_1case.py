"""Real-data CHAOS reproduction on the shipped cases.

The counterpart of the JAX package's ``experiments/chaos_real_1case.py``.
The reference ships complete DICOM and ground-truth data for exactly the two
cases its flagship 1-case config uses: case 37 (the single labeled training
case of splitcases/train_data_1cases.csv) and case 10 (a validation case,
for which the golden eval artifacts report Dice 0.479 for this config,
train_files/examplesegmentationresults/fuseunet_chaoscomparison1case).

This program runs the chaos_comparison_1case setup end to end on that data:
it trains FuseUNet on case 37's 30 DICOM slice pairs, validates every epoch
on case 10, and reports the final case-10 Dice.

It prints one JSON line, the JAX program's keys plus ``seconds``,
``train_steps``, ``warp_launches`` (the TTA warp kernel's host-called
launches in ``Trainer.run``: 0, the run is supervised), ``graph_replays``
(the train steps replayed as a CUDA graph), ``checkpoint`` (the best
epoch's export), ``device_name`` and ``power_limit_w``; ``--out`` writes it.

Usage: python -m aide_tpu_torch.experiments.chaos_real_1case [--epochs N]
       [--reference DIR] [--workdir DIR] [--out F] [--device cpu]
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

from aide_tpu_torch.bench import device_info
from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.engine import checkpoint as ckpt_mod
from aide_tpu_torch.engine import trainer as trainer_mod
from aide_tpu_torch.experiments import reference

REF_ROOT, REF_SPLIT = reference.chaos_paths(reference.REFERENCE)
# the device the run uses: None is the first CUDA card (and raises without
# one), "cpu" the host
DEVICE = None


def make_csvs(workdir: str):
    """Reduce the reference CSVs to the shipped cases (37 train, 10 val)."""
    os.makedirs(workdir, exist_ok=True)
    train_csv = os.path.join(REF_SPLIT, "splitimages_cleanlabel/train_data_1cases.csv")
    val_csv = os.path.join(REF_SPLIT, "splitimages_cleanlabel/val_data_10cases.csv")

    header, rows = reference.read_table(val_csv)
    rows10 = reference.require_rows(val_csv, header, rows, "10")
    val_out = os.path.join(workdir, "val_case10.csv")
    reference.write_table(val_out, header, rows10)

    tc = reference.write_cases(os.path.join(workdir, "traincases.csv"), [37])
    vc = reference.write_cases(os.path.join(workdir, "valcases.csv"), [10])
    return train_csv, val_out, tc, vc


def build_cfg(workdir: str, epochs: int) -> TrainConfig:
    """The JAX program's config, field for field (its ``main`` builds it
    inline); writes the work CSVs."""
    train_csv, val_csv, tc, vc = make_csvs(workdir)
    cfg = TrainConfig()
    cfg.model = ModelConfig(name="fuseunet", compute_dtype="bfloat16")
    cfg.data.task = "chaos"
    cfg.data.variant = "comparison"
    cfg.data.root = REF_ROOT
    cfg.data.train_csv = train_csv
    cfg.data.test_csv = val_csv
    cfg.data.traincase_csv = tc
    cfg.data.testcase_csv = vc
    cfg.data.img_size = 256
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 8
    cfg.num_epochs = epochs
    cfg.repetition = 2
    cfg.checkpoint_dir = os.path.join(workdir, "ckpt")
    cfg.history_dir = os.path.join(workdir, "hist")
    return cfg


def run(workdir: str, epochs: int, prepare=None) -> dict:
    """Train and score; ``prepare(trainer)``, when given, is called just
    before ``trainer.run`` (the tests carry another package's initial
    weights in through it)."""
    cfg = build_cfg(workdir, epochs)
    t0 = time.time()
    trainer = trainer_mod.Trainer(cfg, device=DEVICE)
    if prepare is not None:
        prepare(trainer)
    launched = trace.totals()
    history = trainer.run(epochs)
    spent = trace.delta(launched)
    launches, replays = spent.get("warp.launches", 0), spent.get("train.graph_replays", 0)
    best = max(r["testcase_dice1"] for r in history)
    seconds = time.time() - t0
    return {
        "config": "chaos_comparison_1case (shipped cases 37->10)",
        "epochs": epochs,
        "train_slices": len(trainer.train_pipe),
        "val_slices": len(trainer.test_pipe),
        "final_case10_dice": history[-1]["testcase_dice1"],
        "best_case10_dice": best,
        "golden_reference_case10_dice": 0.479,
        "minutes": round(seconds / 60, 1),
        "seconds": seconds,
        "train_steps": len(history) * trainer.train_pipe.steps_per_epoch(cfg.data.batch_size),
        "warp_launches": launches,
        "graph_replays": replays,
        "checkpoint": ckpt_mod.best_net_path(cfg.checkpoint_dir, cfg.experiment_name),
        **device_info(trainer.device),
    }


def main(argv=None) -> int:
    global REF_ROOT, REF_SPLIT, DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "chaos_real_1case"))
    ap.add_argument("--out", default="")
    reference.add_arguments(ap)
    args = ap.parse_args(argv)
    DEVICE = trainer_mod.resolve_device(args.device)
    REF_ROOT, REF_SPLIT = reference.chaos_paths(args.reference)

    result = run(args.workdir, args.epochs)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
