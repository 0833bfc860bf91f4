"""AIDE against naive training on synthetic imperfect labels: the 3-stage ladder.

The counterpart of the JAX package's ``experiments/synthetic_aide.py``,
function for function, with the same module settings, flags and JSON lines.
It mirrors the reference's CHAOS ladder (pretrain 0.756 -> naive
pseudo-label training 0.799 -> AIDE 0.871):

  1. PRETRAIN: supervised on the clean-labeled cases only (the annotation
     budget).
  2. NAIVE: supervised on every case, the others carrying imperfect masks
     (``shift``: corrupted copies of the ground truth; ``pseudo`` and
     ``transfer``: the pretrained net's predictions).
  3. AIDE: dual-net co-teaching (fresh nets under pseudo and transfer, warm
     started from the pretrain export under shift), TTA pseudo-labels,
     small-loss exchange, consistency, worst-case label refresh with the
     clean cases exempt.

With ``--ceiling`` a supervised run on the clean ground truth of every case
bounds what any label-refinement scheme can reach. Every stage is scored
against CLEAN ground truth on held-out cases; the claim is stage 3 > stage
2. The AIDE stage also prints the working labels' Dice against the clean
ground truth after every refresh (``Trainer.on_refresh``) and the
end-of-ramp engagement verdict.

Each stage prints one JSON line (the JAX program's keys plus ``seconds``,
``train_steps``, ``warp_launches``: the TTA warp kernel's host-called
launches in the stage's ``Trainer.run``, and ``graph_replays``: its steps
replayed as a CUDA graph, whose warp kernels launch with it), then a
summary line with the card's name and power limit; ``--out`` writes
{"runs", "summary"}.

Usage: python -m aide_tpu_torch.experiments.synthetic_aide [--epochs N]
       [--style ellipse|hard|xhard] [--protocol shift|pseudo|transfer]
       [--two-modal] [--ceiling] [--out results.json] [--device cpu] ...
It runs on the first CUDA card and raises without one, unless ``--device``
names another device. ``--packed`` is accepted and changes nothing: the
port runs the plain network, which computes the same.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from aide_tpu_torch.bench import device_info
from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks.base import resize_mask
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as ckpt_mod
from aide_tpu_torch.engine import steps as steps_mod
from aide_tpu_torch.engine.state import TrainState
from aide_tpu_torch.engine.trainer import Trainer, resolve_device
from aide_tpu_torch.evaluation.case_eval import dice3d_np, evaluate_cases, infer_cases
from aide_tpu_torch.models import build_model

NUM_CASES = 18
CLEAN_CASES = 4
SLICES_PER_CASE = 8
MODEL = "unet8"
IMG_SIZE = 64
NOISY_FRACTION = 0.9
NOISE_SHIFT_DIVISOR = 4   # +-16 px shifts at 64 px: corrupted masks barely overlap GT
SEED = 11
STYLE = "ellipse"         # hard / xhard: star-convex shapes, low contrast, distractors
# Where the noisy annotations come from:
#   'shift'    - random shift+morph corruption of the GT masks (the
#                noisy-annotation regime, e.g. kidney annotator errors);
#   'pseudo'   - the net pretrained on the clean budget annotates every
#                unlabeled case and its predictions become the working
#                labels (the reference's limited-annotation CHAOS ladder);
#   'transfer' - the cross-domain prostate protocol: the labeled budget is
#                a SOURCE appearance domain, every other train case and the
#                held-out test split render in a TARGET domain, and the
#                source-pretrained net annotates the target (pseudo +
#                domain_split; labeled source cases stay exempt from refresh).
PROTOCOL = "shift"
DOMAIN_SPLIT = "a:b"      # --direction: source:target appearance domains
# --two-modal: the complementary second acquisition and the FuseUNet family
TWO_MODAL = False
# the JAX package's lane-dense packed layout: accepted, no effect here
PACKED = False
# dotted-key overrides applied to the AIDE stage config only (aide_sweep)
AIDE_OVERRIDES: list = []
# the device every stage runs on: None is the first CUDA card (and raises
# without one), "cpu" the host
DEVICE = None


def build_cfg(stage: str, workdir: str, epochs: int, resume: str = "") -> TrainConfig:
    cfg = TrainConfig()
    cfg.model = ModelConfig(name=MODEL, compute_dtype="bfloat16", norm="batch", packed=PACKED)
    cfg.data.task = "synthetic"
    cfg.data.variant = "proposed" if stage == "aide" else "comparison"
    cfg.data.img_size = IMG_SIZE
    cfg.data.batch_size = 8
    cfg.data.eval_batch_size = 8
    cfg.data.num_tta_views = 4
    cfg.data.rotation_degree = 45.0
    cfg.data.tempmask_folder = f"tempmasks_{stage}"
    cfg.num_epochs = epochs
    if PROTOCOL in ("pseudo", "transfer"):
        # the flagship trainchaos_proposed defaults: fresh dual nets, lr
        # 1e-4, consistency weight 10, up to 20 warmup epochs
        cfg.coteach.warmup_epochs = min(20, max(2, epochs // 3))
    else:
        cfg.coteach.warmup_epochs = max(2, epochs // 3)
        cfg.coteach.consistency_weight = 1.0
        cfg.coteach.update_percent = 0.25
        if stage == "aide":
            # the noisy-annotation regime fine-tunes from the clean anchor
            # at 1e-5 (trainkidney_proposed_mask1.py:39)
            cfg.optim.lr = 1e-5
    cfg.resume_file = resume
    cfg.checkpoint_dir = os.path.join(workdir, f"ckpt_{stage}")
    cfg.history_dir = os.path.join(workdir, f"hist_{stage}")
    if stage == "aide" and AIDE_OVERRIDES:
        cfg = cfg.override(AIDE_OVERRIDES)
    return cfg


def make_task(workdir: str, stage: str, num_cases: int) -> SyntheticTask:
    """Cases are generated per (case, slice, seed), so the clean cases are
    identical across stages whatever ``num_cases`` is."""
    return SyntheticTask(
        root=os.path.join(workdir, f"data_{stage}"),
        tempmask_folder=f"tempmasks_{stage}",
        two_modal=TWO_MODAL,
        num_cases=num_cases,
        slices_per_case=SLICES_PER_CASE,
        size=IMG_SIZE,
        # pseudo/transfer: the unlabeled cases start with GT that
        # apply_pseudo_labels overwrites with the pretrained net's
        # predictions; no artificial corruption
        noisy_fraction=0.0 if PROTOCOL in ("pseudo", "transfer") else NOISY_FRACTION,
        clean_cases=CLEAN_CASES,
        noise_shift_divisor=NOISE_SHIFT_DIVISOR,
        style=STYLE,
        seed=SEED,
        domain_split=DOMAIN_SPLIT if PROTOCOL == "transfer" else "",
        test_case_offset=100,   # held-out anatomy, clean labels
        num_test_cases=8,
    )


def _single_net(cfg: TrainConfig, path: str, device: torch.device, two_modal: bool):
    """One net of ``cfg.model`` with an export's weights (a ``.pkl`` or a
    JAX ``.msgpack``) on ``device``, and the single-net predict program,
    which moves host batches to the device."""
    net = build_model(cfg.model)
    net.load_state_dict(ckpt_mod.load_net(path, net), strict=True)
    state = TrainState(net.to(device, memory_format=torch.channels_last), optimizer=None)
    predict_step = steps_mod.make_predict_step(two_modal, dual=False)

    def predict(state, batch):
        return predict_step(state, {k: v.to(device, non_blocking=True) for k, v in batch.items()})

    return state, predict


def apply_pseudo_labels(trainer: Trainer, pretrain_ckpt: str) -> float:
    """The reference's limited-annotation protocol: the net pretrained on
    the labeled budget annotates every unlabeled case, and its predictions
    become the labels the next stage trains on (both nets' working labels
    under co-teaching, the targets of the supervised naive stage). Returns
    and prints their mean case Dice against the clean ground truth."""
    pipe = trainer.train_pipe
    state, predict = _single_net(trainer.cfg, pretrain_ckpt, trainer.device, trainer.two_modal)
    cases = [c for c in pipe.cases if c not in trainer.label_cases]
    volumes = infer_cases(predict, state, pipe, cases, trainer.cfg.data.eval_batch_size,
                          dual=False)
    qs = []
    for case, vols in zip(cases, volumes):
        idxs = pipe.case_indices(case)
        vol = vols[0].astype(np.uint8)
        # pipe.targets are still the GT here (pseudo protocol)
        qs.append(dice3d_np(vol, pipe.targets[idxs]))
        if trainer.dual:
            for net in (1, 2):
                pipe.labels.refresh_case(net, idxs, vol)
        else:
            pipe.targets[idxs] = vol
    if trainer.dual:
        # the changed rows into the device copy (each rank's block of a
        # sharded cache); without one it only clears the record
        pipe.sync_labels_to_device()
    elif pipe._device_data is not None or pipe._sharded is not None:
        # the targets are uploaded whole: again, in the trainer's placement
        pipe.to_device(trainer.device)
    quality = float(np.mean(qs))
    print(json.dumps({"pseudo_label_quality": round(quality, 4)}), flush=True)
    return quality


def eval_ckpt_on_domain(ckpt_path: str, workdir: str, domain: str) -> float:
    """Held-out eval of a single-net export with the test anatomy rendered in
    ``domain``: the pretrain's skill WITHIN its source domain beside its
    cross-domain number (the reference's singledomain-vs-transfer configs)."""
    cfg = build_cfg(f"domval_{domain}", workdir, 1)
    task = make_task(workdir, f"domval_{domain}", CLEAN_CASES)
    task.domain_split = f"{domain}:{domain}"  # the test split renders `domain`
    specs = task.load_manifest(train=False)
    pipe = SlicePipeline(task, specs, cfg.data.img_size, cfg.data.data_mean,
                         cfg.data.data_std, working_labels=False)
    state, predict = _single_net(cfg, ckpt_path, resolve_device(DEVICE), TWO_MODAL)
    results = evaluate_cases(predict, state, pipe, list(pipe.cases), cfg.data.eval_batch_size,
                             dual=False)
    return round(float(np.mean([r.dice for r in results[0]])), 4)


def clean_gt(trainer: Trainer) -> np.ndarray:
    """Clean ground-truth masks for every train slice, whatever the
    protocol. Under pseudo and transfer ``pipe.targets`` ARE the clean GT;
    under shift they hold the corrupted annotations, so a clone generator
    with noisy_fraction=0 (same seed and style: the mask is drawn before the
    corruption decision) renders the clean masks once, cached on the
    trainer."""
    cached = getattr(trainer, "_clean_gt", None)
    if cached is not None:
        return cached
    pipe = trainer.train_pipe
    if PROTOCOL in ("pseudo", "transfer"):
        gt = pipe.targets
    else:
        t = trainer.task
        clone = SyntheticTask(
            root=t.root, two_modal=t.two_modal, num_cases=t.num_cases,
            slices_per_case=t.slices_per_case, size=t.size,
            noisy_fraction=0.0, clean_cases=t.clean_cases,
            noise_shift_divisor=t.noise_shift_divisor, style=t.style,
            seed=t.seed, test_case_offset=t.test_case_offset,
            num_test_cases=t.num_test_cases, domain_split=t.domain_split,
        )
        gt = np.zeros_like(pipe.targets)
        for i, spec in enumerate(pipe.specs):
            _, mask = clone.decode(spec)
            if mask.shape != gt.shape[1:]:
                mask = resize_mask(mask, gt.shape[1:])
            gt[i] = (mask > 0).astype(gt.dtype)
    trainer._clean_gt = gt
    return gt


def label_quality(trainer: Trainer) -> float:
    """Mean Dice of both nets' working labels against the clean GT over the
    non-clean cases: the oracle of whether refresh helps or hurts."""
    pipe = trainer.train_pipe
    gt = clean_gt(trainer)
    qs = []
    for case in pipe.cases:
        if case in trainer.label_cases:
            continue
        idxs = pipe.case_indices(case)
        for net in (1, 2):
            qs.append(dice3d_np(pipe.labels.get(net)[idxs], gt[idxs]))
    return round(float(np.mean(qs)), 4)


def run(stage: str, workdir: str, epochs: int, resume: str = "", pseudo_from: str = "",
        prepare=None) -> dict:
    """One stage of the ladder. ``prepare(trainer, stage)``, when given, is
    called just before ``trainer.run`` (the tests carry another package's
    initial weights and view parameters in through it)."""
    num_cases = CLEAN_CASES if stage == "pretrain" else NUM_CASES
    task = make_task(workdir, stage, num_cases)
    if stage == "ceiling":
        # supervised on the clean GT of every case: the oracle ceiling
        task.noisy_fraction = 0.0
    cfg = build_cfg(stage, workdir, epochs, resume)
    t0 = time.time()
    trainer = Trainer(cfg, task=task, device=DEVICE)
    trainer.label_cases = set(task.clean_case_ids())
    if pseudo_from and PROTOCOL in ("pseudo", "transfer"):
        q0 = apply_pseudo_labels(trainer, pseudo_from)
        if trainer.dual:
            # the measured bootstrap quality feeds the end-of-ramp
            # cliff/transition/clear verdict (a practitioner scores the
            # source model on a few labeled target cases first)
            trainer.engagement_probe = {"bootstrap_skill1": q0, "bootstrap_skill2": q0}
    quality_track = []
    if trainer.dual:
        # the per-refresh label-quality oracle: the working labels must
        # improve across refreshes for the regime to be healthy
        def on_refresh(epoch):
            q = label_quality(trainer)
            quality_track.append({"epoch": epoch + 1, "label_quality": q})
            print(json.dumps(quality_track[-1]), flush=True)

        trainer.on_refresh = on_refresh
    if prepare is not None:
        prepare(trainer, stage)
    launched = trace.totals()
    history = trainer.run(epochs)
    spent = trace.delta(launched)
    launches, replays = spent.get("warp.launches", 0), spent.get("train.graph_replays", 0)
    last = history[-1]
    best_test = max(
        max(r.get("testcase_dice1", 0.0), r.get("testcase_dice2", 0.0)) for r in history
    )
    quality = label_quality(trainer) if trainer.dual else None
    seconds = time.time() - t0
    return {
        **({"final_label_quality": quality} if quality is not None else {}),
        **({"label_quality_track": quality_track} if trainer.dual else {}),
        # the run-time (oracle-free) engagement verdict at the end of the
        # warmup ramp
        **(
            {"engagement": trainer.engagement}
            if trainer.dual and trainer.engagement is not None
            else {}
        ),
        **(
            {"engagement_probe": trainer.engagement_probe}
            if trainer.dual and trainer.engagement_probe is not None
            else {}
        ),
        **(
            {"crossnet_dice_track": [
                {"epoch": r["epoch"], "crossnet_dice": round(r["crossnet_dice"], 4)}
                for r in history if "crossnet_dice" in r
            ]}
            if trainer.dual
            else {}
        ),
        "stage": stage,
        "epochs": epochs,
        "final_testcase_dice": max(
            last.get("testcase_dice1", 0.0), last.get("testcase_dice2", 0.0)
        ),
        "best_testcase_dice": best_test,
        "minutes": round(seconds / 60, 1),
        "seconds": seconds,
        "train_steps": len(history) * trainer.train_pipe.steps_per_epoch(cfg.data.batch_size),
        "warp_launches": launches,
        "graph_replays": replays,
        # the file the port writes: the best epoch's export (net 1 of the pair)
        "checkpoint": ckpt_mod.best_net_path(
            cfg.checkpoint_dir, cfg.experiment_name, 1 if stage == "aide" else None
        ),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=40)
    # the pretrain stage sees only the clean cases (few steps an epoch) and
    # needs many epochs to converge, like the reference's 100-epoch pretrain
    ap.add_argument("--pretrain-epochs", type=int, default=60)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "aide_torch_synth_exp"))
    ap.add_argument("--out", default="")
    ap.add_argument("--style", default="ellipse", choices=("ellipse", "hard", "xhard"))
    ap.add_argument("--protocol", default="shift", choices=("shift", "pseudo", "transfer"))
    ap.add_argument("--direction", default="a:b",
                    help="transfer protocol source:target appearance domains (a:b or b:a)")
    ap.add_argument("--num-cases", type=int, default=NUM_CASES)
    ap.add_argument("--slices-per-case", type=int, default=SLICES_PER_CASE)
    ap.add_argument("--model", default=MODEL)
    ap.add_argument("--img-size", type=int, default=IMG_SIZE)
    ap.add_argument("--ceiling", action="store_true",
                    help="also run the supervised-on-clean-GT oracle stage")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="synthetic data generator seed (case anatomy)")
    ap.add_argument("--clean-cases", type=int, default=CLEAN_CASES)
    ap.add_argument("--shift-divisor", type=int, default=NOISE_SHIFT_DIVISOR)
    ap.add_argument("--packed", action="store_true",
                    help="the JAX package's packed layout: accepted, no effect here")
    ap.add_argument("--two-modal", action="store_true",
                    help="complementary second acquisition + fuseunet-family models "
                         "(the reference's flagship CHAOS setup)")
    ap.add_argument("--aide-override", action="append", default=[],
                    help="dotted config override applied to the AIDE stage only "
                         "(repeatable), e.g. coteach.warmup_epochs=60")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the first CUDA card; "
                         "'cpu' runs on the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    global STYLE, CLEAN_CASES, NOISE_SHIFT_DIVISOR, PROTOCOL, DOMAIN_SPLIT
    global NUM_CASES, SLICES_PER_CASE, MODEL, SEED, IMG_SIZE, TWO_MODAL
    global PACKED, AIDE_OVERRIDES, DEVICE
    args = parse_args(argv)
    device = resolve_device(args.device)

    STYLE = args.style
    PROTOCOL = args.protocol
    DOMAIN_SPLIT = args.direction
    IMG_SIZE = args.img_size
    NUM_CASES = args.num_cases
    SLICES_PER_CASE = args.slices_per_case
    MODEL = args.model
    SEED = args.seed
    CLEAN_CASES = args.clean_cases
    NOISE_SHIFT_DIVISOR = args.shift_divisor
    TWO_MODAL = args.two_modal
    PACKED = args.packed
    AIDE_OVERRIDES = list(args.aide_override)
    DEVICE = device

    os.makedirs(args.workdir, exist_ok=True)
    results = {}
    if args.ceiling:
        results["ceiling"] = run("ceiling", args.workdir, args.epochs)
        print(json.dumps(results["ceiling"]), flush=True)
    results["pretrain"] = run("pretrain", args.workdir, args.pretrain_epochs)
    print(json.dumps(results["pretrain"]), flush=True)

    if PROTOCOL == "transfer":
        # the domain gap: the same export on held-out anatomy rendered in
        # the SOURCE domain (its training distribution)
        src = DOMAIN_SPLIT.split(":")[0]
        results["pretrain"]["source_domain_dice"] = eval_ckpt_on_domain(
            results["pretrain"]["checkpoint"], args.workdir, src
        )
        print(json.dumps({"pretrain_source_domain_dice":
                          results["pretrain"]["source_domain_dice"]}), flush=True)

    results["naive"] = run(
        "naive", args.workdir, args.epochs, pseudo_from=results["pretrain"]["checkpoint"],
    )
    print(json.dumps(results["naive"]), flush=True)

    results["aide"] = run(
        "aide", args.workdir, args.epochs,
        # shift: the clean-anchored warm start (kidney protocol); pseudo and
        # transfer: fresh dual nets like the CHAOS/prostate flagships (random
        # init is the co-teaching asymmetry)
        resume="" if PROTOCOL in ("pseudo", "transfer") else results["pretrain"]["checkpoint"],
        pseudo_from=results["pretrain"]["checkpoint"],
    )
    print(json.dumps(results["aide"]), flush=True)

    summary = {
        "style": STYLE,
        "protocol": PROTOCOL,
        **({"direction": DOMAIN_SPLIT} if PROTOCOL == "transfer" else {}),
        "seed": SEED,
        "model": MODEL,
        "two_modal": TWO_MODAL,
        "slices_per_case": SLICES_PER_CASE,
        # the effective value: pseudo/transfer apply no corruption
        "noisy_fraction": 0.0 if PROTOCOL in ("pseudo", "transfer") else NOISY_FRACTION,
        "noise_shift_divisor": NOISE_SHIFT_DIVISOR,
        "clean_cases": CLEAN_CASES,
        "num_cases": NUM_CASES,
        **({"ceiling_best_dice": results["ceiling"]["best_testcase_dice"]}
           if "ceiling" in results else {}),
        "img_size": IMG_SIZE,
        **(
            {"pretrain_source_dice": results["pretrain"].get("source_domain_dice")}
            if PROTOCOL == "transfer" else {}
        ),
        "pretrain_best_dice": results["pretrain"]["best_testcase_dice"],
        "naive_best_dice": results["naive"]["best_testcase_dice"],
        "aide_best_dice": results["aide"]["best_testcase_dice"],
        "aide_over_naive": round(
            results["aide"]["best_testcase_dice"] - results["naive"]["best_testcase_dice"], 4
        ),
        "aide_over_pretrain": round(
            results["aide"]["best_testcase_dice"] - results["pretrain"]["best_testcase_dice"], 4
        ),
        # the card's name and power limit beside the minutes
        **device_info(device),
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"runs": results, "summary": summary}, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
