"""Real-DICOM co-teaching: the flagship AIDE proposed path on shipped data.

The counterpart of the JAX package's ``experiments/chaos_real_proposed.py``.
It runs the dual-net proposed algorithm (TTA ensembling, cross small-loss
exchange, label refresh) end to end on the reference's shipped CHAOS DICOM:
the machinery of the ``chaos_proposed_30cases1labeled`` preset
(trainchaos_proposed_30cases1labeled.py), scaled to the two cases whose
images ship with the reference:

  - case 37: the single LABELED case (ground-truth masks, refresh-exempt,
    splitcases/train_data_1cases.csv), 30 slice pairs;
  - case 10: pseudo-labeled from the shipped bootstrap masks
    (generated_masks/pretrain_1case_fuseunet_r1/10/, the 1-case pretrain's
    predictions), 50 slice pairs, the only refreshable case;
  - test: case 10 scored against its ground truth.

Deviation from the flagship config, forced by the 2-case dataset:
``update_percent`` is raised 0.25 -> 0.5 so that the per-net worst-k
refresh selects k = int(0.5 * 2) = 1 case an epoch (0.25 of 2 cases gives
k = 0 and no refresh). Case 37 stays exempt, so each refresh rewrites at
most case 10's working labels.

An oracle (``Trainer.on_refresh``) prints the working labels' Dice against
case 10's ground truth after every refresh (``# label oracle`` lines).

The reference tree is read only: a writable root under ``--workdir``
symlinks the case folders and the pseudo-masks, and the tempmasks,
checkpoints and decode cache are written under the work directory.

It prints one JSON line, the JAX program's keys plus ``seconds``,
``train_steps``, ``warp_launches`` (the TTA warp kernel's host-called
launches in ``Trainer.run``, 3 an eager or captured step),
``graph_replays`` (the steps replayed as a CUDA graph, whose warp kernels
launch with it), ``checkpoint`` (net 1's best export),
``device_name`` and ``power_limit_w``; ``--out`` writes it with the oracle
rows and the history.

Usage: python -m aide_tpu_torch.experiments.chaos_real_proposed
       [--epochs N] [--reference DIR] [--workdir DIR] [--out F] [--device cpu]
It runs on the first CUDA card and raises without one, unless ``--device``
names another device. ``model.packed`` is set as the JAX program sets it
and changes nothing: the port runs the plain network.
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
from aide_tpu_torch.evaluation.case_eval import dice3d_np
from aide_tpu_torch.experiments import reference

REF_ROOT, REF_SPLIT = reference.chaos_paths(reference.REFERENCE)
PSEUDO_REL = "generated_masks/pretrain_1case_fuseunet_r1"
# the device the run uses: None is the first CUDA card (and raises without
# one), "cpu" the host
DEVICE = None


def make_workdir(workdir: str):
    """Writable data root (symlinked cases) + train/test/case CSVs."""
    root = os.path.join(workdir, "root")
    os.makedirs(root, exist_ok=True)
    for name in ("10", "37", "generated_masks"):
        link = os.path.join(root, name)
        if not os.path.lexists(link):
            os.symlink(os.path.join(REF_ROOT, name), link)

    # case 37's rows of the proposed 30-case CSV carry its ground-truth
    # masks (the labeled case); case 10's rows come from the val CSV with
    # the Mask column pointed at the shipped bootstrap pseudo-labels
    csv30 = os.path.join(REF_SPLIT, "splitimages_pseudolabels_1pretrain/train_data_30cases.csv")
    header, rows30 = reference.read_table(csv30)
    rows37 = reference.require_rows(csv30, header, rows30, "37", count=30)

    val_csv = os.path.join(REF_SPLIT, "splitimages_cleanlabel/val_data_10cases.csv")
    val_header, val_rows = reference.read_table(val_csv)
    test10 = reference.require_rows(val_csv, val_header, val_rows, "10", count=50)
    if header != val_header:
        raise ValueError(f"{csv30!r} and {val_csv!r} have other columns")
    inphase, mask = val_header.index("Inphase"), val_header.index("Mask")
    rows10 = [list(r) for r in test10]
    for r in rows10:
        r[mask] = f"{PSEUDO_REL}/10/{os.path.basename(r[inphase]).rsplit('.', 1)[0]}.png"
        if not os.path.exists(os.path.join(root, r[mask])):
            raise FileNotFoundError(f"no bootstrap pseudo-label {r[mask]} under {root}")

    train_csv = os.path.join(workdir, "train_37gt_10pseudo.csv")
    reference.write_table(train_csv, header, rows37 + rows10)
    test_csv = os.path.join(workdir, "test_case10_gt.csv")
    reference.write_table(test_csv, val_header, test10)

    def case_csv(name, cases):
        return reference.write_cases(os.path.join(workdir, name), cases)

    return (
        root,
        train_csv,
        test_csv,
        case_csv("traincases.csv", [37, 10]),
        case_csv("testcases.csv", [10]),
        case_csv("labelcases.csv", [37]),
    )


def build_cfg(workdir: str, epochs: int) -> TrainConfig:
    """The JAX program's config, field for field (its ``main`` builds it
    inline); makes the work root and CSVs."""
    root, train_csv, test_csv, tc, vc, lc = make_workdir(workdir)
    cfg = TrainConfig()
    # the flagship production mode: packed bf16 FuseUNet (bench.py, presets)
    cfg.model = ModelConfig(name="fuseunet", compute_dtype="bfloat16", packed=True)
    cfg.data.task = "chaos"
    cfg.data.variant = "proposed"
    cfg.data.root = root
    cfg.data.train_csv = train_csv
    cfg.data.test_csv = test_csv
    cfg.data.traincase_csv = tc
    cfg.data.testcase_csv = vc
    cfg.data.labelcase_csv = lc
    cfg.data.tempmask_folder = "tempmasks_real_proposed"
    cfg.data.decode_cache_dir = os.path.join(workdir, "decode_cache")
    cfg.data.eval_batch_size = 32
    cfg.coteach.update_percent = 0.5  # k=1 of 2 cases (see module docstring)
    cfg.num_epochs = epochs
    cfg.checkpoint_dir = os.path.join(workdir, "ckpt")
    cfg.history_dir = os.path.join(workdir, "hist")
    cfg.repetition = 5  # experiment tag (experiment_name derives from it)
    return cfg


def run(workdir: str, epochs: int, prepare=None) -> dict:
    """Train with the oracle; returns the summary and, under ``label_oracle``
    and ``history``, the oracle rows and the history. ``prepare(trainer)``,
    when given, is called just before ``trainer.run`` (the tests carry
    another package's initial weights and view parameters in through it)."""
    cfg = build_cfg(workdir, epochs)
    t0 = time.time()
    trainer = trainer_mod.Trainer(cfg, device=DEVICE)

    # working-label oracle for case 10 (ground truth from the test pipe: the
    # train pipe's targets are the pseudo bootstrap)
    gt10 = trainer.test_pipe.case_targets("10") > 0
    idx10 = trainer.train_pipe.case_indices("10")
    bootstrap = {
        net: dice3d_np(trainer.train_pipe.labels.get(net)[idx10], gt10) for net in (1, 2)
    }
    label_oracle = []

    def on_refresh(epoch):
        row = {"epoch": epoch + 1}
        for net in (1, 2):
            row[f"label_dice{net}"] = round(
                dice3d_np(trainer.train_pipe.labels.get(net)[idx10], gt10), 4
            )
        label_oracle.append(row)
        print(f"# label oracle {row}", flush=True)

    trainer.on_refresh = on_refresh
    if prepare is not None:
        prepare(trainer)
    launched = trace.totals()
    history = trainer.run(epochs)
    spent = trace.delta(launched)
    launches, replays = spent.get("warp.launches", 0), spent.get("train.graph_replays", 0)

    best = {n: max(r[f"testcase_dice{n}"] for r in history) for n in (1, 2)}
    # the reference's deployment rule: the checkpoint saved at the best
    # traincase-dice epoch (the trainer's best-dice gate); its test dice
    best_tc_epoch = max(history, key=lambda r: (r["traincase_dice1"] + r["traincase_dice2"]) / 2)
    seconds = time.time() - t0
    result = {
        "config": "chaos_proposed (cases 37 GT + 10 pseudo -> test 10 GT)",
        "epochs": epochs,
        "train_slices": len(trainer.train_pipe),
        "bootstrap_label_dice_case10": round(bootstrap[1], 4),
        "final_case10_dice": {n: round(history[-1][f"testcase_dice{n}"], 4) for n in (1, 2)},
        "best_case10_dice": {n: round(best[n], 4) for n in (1, 2)},
        "at_checkpoint_gate": {
            n: round(best_tc_epoch[f"testcase_dice{n}"], 4) for n in (1, 2)
        },
        "gate_epoch": best_tc_epoch["epoch"],
        "label_oracle_last": label_oracle[-1] if label_oracle else None,
        "label_oracle_peak": (
            max(
                max(r["label_dice1"] for r in label_oracle),
                max(r["label_dice2"] for r in label_oracle),
            )
            if label_oracle
            else None
        ),
        "golden_reference_case10_dice_supervised1case": 0.479,
        "our_comparison_run_case10": {"final": 0.495, "best": 0.594},
        "minutes": round(seconds / 60, 1),
        "seconds": seconds,
        "train_steps": len(history) * trainer.train_pipe.steps_per_epoch(cfg.data.batch_size),
        "warp_launches": launches,
        "graph_replays": replays,
        "checkpoint": ckpt_mod.best_net_path(cfg.checkpoint_dir, cfg.experiment_name, 1),
        **device_info(trainer.device),
    }
    return {**result, "label_oracle": label_oracle, "history": history}


def main(argv=None) -> int:
    global REF_ROOT, REF_SPLIT, DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "chaos_real_proposed"))
    ap.add_argument("--out", default="")
    reference.add_arguments(ap)
    args = ap.parse_args(argv)
    DEVICE = trainer_mod.resolve_device(args.device)
    REF_ROOT, REF_SPLIT = reference.chaos_paths(args.reference)

    full = run(args.workdir, args.epochs)
    result = {k: v for k, v in full.items() if k not in ("label_oracle", "history")}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(full, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
