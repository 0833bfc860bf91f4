"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n> [--first-seed <s>]
        [--controls <k>] [--also-seed <s> ...]

For each seed the port runs the warm-up epoch of the cell (its checked
steps, case evaluation and refresh) and is held to the float32 reference
(the lower readings); for the first ``--controls`` seeds also the control,
the reference with every convolution in fp8 (e4m3), and each fault the
cell can have, planted in the reference put in the port's place: half of
each batch left out, an answer altered where it is produced (one slice
of one case's labels from the predict program inverted), and for co-teaching the refresh left out
and the refresh given the best cases for the worst. A state left
unchanged reads 1 by ``update_gap`` and needs no run. One JSON line a
seed on standard output; no window runs.
"""

from __future__ import annotations

import argparse
import copy
import json
import shutil
import sys
import tempfile

from benchmark import checks, common, manifest as mf, run, weights
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import steps as ref_steps


def _as_program(ref, k, label_cases, skip_empty):
    """The reference's own evaluation and refresh, put in the port's place."""
    out = {"raw": dict(ref["raw"]), "dice": dict(ref["dice"]),
           "kept": {key: ref_eval.largest_component(raw) for key, raw in ref["raw"].items()}}
    if len(ref["pred"]) == 2:
        out["selected"], out["labels"] = {}, {}
        for net in (0, 1):
            dice_of = {c: d for (kind, n, c), d in ref["dice"].items()
                       if kind == "train" and n == net}
            pred = {c: out["kept"]["train", net, c] for c in ref["initial"]}
            out["selected"][net], out["labels"][net] = ref_eval.refresh(
                dice_of, pred, ref["initial"], k, label_cases, skip_empty)
    return out


def _epoch_faults(ref, k, label_cases, skip_empty):
    """The epoch's faults, planted in the reference put in the port's place:
    an answer altered where it is produced (the middle slice of one train
    case's labels from the predict program inverted: net 0's worst
    refreshed case, or case01; its component, Dice and refresh follow),
    the refresh left out, the refresh given the best cases for the worst."""
    base = _as_program(ref, k, label_cases, skip_empty)
    faults = {}
    altered = copy.deepcopy(base)
    chosen = [c for c in base.get("selected", {0: []})[0] if c not in label_cases]
    case = chosen[0] if chosen else "case01"
    raw = ref["raw"]["train", 0, case].copy()
    raw[len(raw) // 2] ^= 1
    kept = ref_eval.largest_component(raw)
    altered["raw"]["train", 0, case], altered["kept"]["train", 0, case] = raw, kept
    altered["dice"]["train", 0, case] = ref_eval.dice(kept, ref["initial"][case])
    if "labels" in altered and case in chosen:
        altered["labels"][0][case] = kept
    faults["fault_altered_answer"] = altered
    if "labels" in base:
        skipped = copy.deepcopy(base)
        skipped["labels"] = {n: dict(ref["initial"]) for n in (0, 1)}
        faults["fault_refresh_left_out"] = skipped
        best = {}
        for net in (0, 1):
            dice_of = {c: d for (kind, n, c), d in base["dice"].items()
                       if kind == "train" and n == net}
            best[net] = sorted(dice_of, key=lambda c: -dice_of[c])[:k]
        reversed_ = copy.deepcopy(base)
        reversed_["selected"] = best
        reversed_["labels"] = {
            n: {c: (base["kept"]["train", n, c] if c in best[n] and c not in label_cases
                    else ref["initial"][c]) for c in ref["initial"]} for n in (0, 1)}
        faults["fault_best_refreshed"] = reversed_
    return faults


def train_seed(config, traffic, seed, device, controls: bool):
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer
    from benchmark.drivers.epochs import EpochAnswers, FirstSteps

    dual = traffic["variant"] == "proposed"
    data = common.data_spec(config, seed)
    first, checked = traffic["first_epoch"], traffic["checked_steps"]
    workdir = tempfile.mkdtemp(prefix="calibrate_")
    try:
        cfg = common.train_config(config, traffic["variant"], seed, workdir)
        task = SyntheticTask(root=cfg.data.root, tempmask_folder="tempmasks",
                             **common.task_options(data))
        trainer = Trainer(cfg, task=task, device=device)
        trainer.label_cases = set(task.clean_case_ids())
        sds = weights.make(config["model"], seed ^ 0x5EED, device, len(trainer.state.nets))
        for net, sd in zip(trainer.state.nets, sds):
            net.load_state_dict(sd)
        recorder, answers = FirstSteps(trainer, checked), EpochAnswers(trainer)
        trainer.run_epoch(first)
        recorder.detach()
        evaluated = answers.finish(first)
        prog = recorder.readings
        del trainer, task, recorder, answers
        common.free_device(device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def ref(**kw):
        return ref_steps.readings(config, data, dual, sds, seed, first, checked, device, **kw)

    k = int(config["update_percent"] * data["train_cases"])
    label_cases = [f"case{c:02d}" for c in range(data["clean_cases"])]
    skip = config["refresh_skip_empty"]
    base = ref()
    base_eval = ref_eval.answers(config, data, evaluated["weights"], device)
    out = {"seed": seed,
           "port": dict(checks.train_numbers(prog, base),
                        **checks.epoch_numbers(evaluated, base_eval, k, label_cases, skip)),
           "port_diagnostics": dict(checks.train_diagnostics(prog, base),
                                    predict_worst=checks.epoch_worst(evaluated, base_eval))}
    if controls:
        for name, kw in (("control_fp8", {"precision": "fp8"}), ("fault_half_batch",
                                                                  {"half": True})):
            readings = ref(**kw)
            out[name] = checks.train_numbers(readings, base)
            out[f"{name}_diagnostics"] = checks.train_diagnostics(readings, base)
        control = ref_eval.answers(config, data, evaluated["weights"], device, "fp8")
        out["control_fp8"].update(checks.epoch_numbers(
            _as_program(control, k, label_cases, skip), base_eval, k, label_cases, skip))
        for name, readings in _epoch_faults(base_eval, k, label_cases, skip).items():
            out[name] = checks.epoch_numbers(readings, base_eval, k, label_cases, skip)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=4_000_000_001)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--also-seed", type=int, action="append", default=[],
                    help="a seed read before the others, without the control (repeatable)")
    args = ap.parse_args(argv)
    run.set_cache_dirs(mf.ROOT)
    manifest = mf.load()
    w = mf.workload(manifest, args.workload)
    config, traffic = mf.config(w["config"]), mf.traffic(w["traffic"])
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.also_seed:
        print(json.dumps(train_seed(config, traffic, seed, device, False)), flush=True)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        print(json.dumps(train_seed(config, traffic, seed, device, i < args.controls)),
              flush=True)
    bad = run.forbidden_modules()
    if bad:
        raise RuntimeError(f"loaded the JAX package or JAX: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
