"""Whole epochs of the port's ``Trainer.run_epoch``.

Set-up builds one Trainer (the synthetic dataset generated, decoded and
uploaded; the nets), loads the seed's weights into it and runs one
warm-up epoch, ``traffic["first_epoch"]``, through the window's own call:
its first three steps are recorded for the check (their losses, the first
gradient from AMSGrad's first moment, each leaf's change), and so are its
case evaluation (each net's labels of each case before and after the
largest component, and their 3D Dice), the nets' weights it
evaluated and the working labels its refresh left. The window then runs
whole epochs from the next one on (``stats.whole_epochs``); ``epoch_s`` is
their mean. With ``--trace 1`` one more epoch follows: its first step
under FlopCounterMode, and a few steps from its middle under
torch.profiler. After the window the port's state is freed; the reference
takes the same three steps from the same weights, and evaluates the
warm-up epoch's cases from the weights that epoch evaluated them with.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

from benchmark import checks, common, stats, weights
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import steps as ref_steps

B1 = 0.9  # AMSGrad's first-moment decay (optax's default, AIDE's)


class FirstSteps:
    """Wraps ``trainer.train_step`` and records the first ``count`` steps:
    each net's loss, the first gradient (first moment / (1 - b1) after
    one step) and each leaf's change after the last one."""

    def __init__(self, trainer, count: int):
        self.trainer, self.step, self.count, self.calls = trainer, trainer.train_step, count, 0
        self.named = [(f"net{k}.{n}", p) for k, net in enumerate(trainer.state.nets)
                      for n, p in net.named_parameters()]
        self.start = [p.detach().clone() for _, p in self.named]
        self.readings: Dict = {"losses": []}
        trainer.train_step = self

    def __call__(self, state, *args):
        m = self.step(state, *args)
        if self.calls < self.count:
            keys = ("loss1", "loss2") if "loss1" in m else ("loss",)
            self.readings["losses"].append([float(m[k]) for k in keys])
            if self.calls == 0:
                opt = state.optimizer
                self.readings["grad"] = {n: float(opt.state[p]["mu"].norm()) / (1.0 - B1)
                                         for n, p in self.named}
            if self.calls == self.count - 1:
                self.readings["change"] = {n: float((p.detach() - p0).norm())
                                           for (n, p), p0 in zip(self.named, self.start)}
        self.calls += 1
        return m

    def detach(self) -> None:
        self.trainer.train_step = self.step


class EpochAnswers:
    """Records one epoch's case evaluation: each net's labels of each test
    and train case as the predict program gave them, the component kept of
    them, and its 3D Dice as ``score_case_volumes`` reports it to the
    trainer. ``finish`` adds the nets' weights (which the epoch evaluated
    with; the next train step changes them) and, for co-teaching, the cases
    each net chose to refresh and the working labels after the refresh."""

    def __init__(self, trainer):
        from aide_tpu_torch.engine import trainer as trainer_mod
        from aide_tpu_torch.evaluation import case_eval

        self.trainer = trainer
        self.readings = {"dice": {}, "raw": {}, "kept": {}}
        score, keep = case_eval.score_case_volumes, case_eval.keep_largest_connected_components
        self.patched = [(m, "score_case_volumes", score) for m in (case_eval, trainer_mod)]
        self.patched.append((case_eval, "keep_largest_connected_components", keep))
        raw_of: Dict[int, tuple] = {}  # id of a kept volume: (it, the labels it was kept from)

        def kept(vol):
            out = keep(vol)
            raw_of[id(out)] = (out, vol.copy())
            return out

        def recorded(pipe, cases, volumes, *args, **kw):
            results = score(pipe, cases, volumes, *args, **kw)
            kind = "train" if pipe is trainer.train_pipe else "test"
            for case, vols in zip(cases, volumes):
                for net, vol in vols.items():
                    key = kind, net, str(case)
                    self.readings["kept"][key] = np.array(vol, np.uint8)
                    if id(vol) in raw_of:
                        self.readings["raw"][key] = raw_of.pop(id(vol))[1]
            for net, per_case in results.items():
                for r in per_case:
                    self.readings["dice"][kind, net, r.case_id] = float(r.dice)
            return results

        case_eval.score_case_volumes = trainer_mod.score_case_volumes = recorded
        case_eval.keep_largest_connected_components = kept

    def finish(self, epoch: int) -> Dict:
        import torch

        for module, name, original in self.patched:
            setattr(module, name, original)
        t = self.trainer
        self.readings["weights"] = [
            {k: v.detach().to("cpu", torch.float32, copy=True).contiguous()
             for k, v in net.state_dict().items()}
            for net in t.state.nets]
        if t.dual:
            self.readings["selected"] = {n - 1: list(sel) for e, n, sel, _ in t.refresh_log
                                         if e == epoch}
            pipe = t.train_pipe
            self.readings["labels"] = {
                n - 1: {c: pipe.labels.get(n)[pipe.case_indices(c)].copy() for c in pipe.cases}
                for n in (1, 2)}
        self.trainer = None
        return self.readings


def epoch_reference(config: Dict, data: Dict, readings: Dict, device) -> Dict:
    """The check's numbers of an epoch's evaluation and refresh
    (``checks.epoch_numbers``), ``readings`` as ``EpochAnswers`` made them."""
    ref = ref_eval.answers(config, data, readings["weights"], device)
    label_cases = [f"case{c:02d}" for c in range(data["clean_cases"])]
    k = int(config["update_percent"] * data["train_cases"])
    print(f"# predict_gap reads at {checks.epoch_worst(readings, ref)}", file=sys.stderr,
          flush=True)
    return checks.epoch_numbers(readings, ref, k, label_cases, config["refresh_skip_empty"])


def profiled_epoch(trainer, epoch: int, steps: int, device):
    """``run_epoch(epoch)`` with its first step counted by FlopCounterMode
    and ``steps`` steps from its middle profiled. Returns (profile
    summary, model FLOPs of a step)."""
    from torch.utils.flop_counter import FlopCounterMode

    spe = trainer.train_pipe.steps_per_epoch(trainer.cfg.data.batch_size)
    at = max(1, (spe - steps) // 2)
    steps = min(steps, spe - at)
    prof = common.Profiled(device)
    step = trainer.train_step
    flops: List[int] = []
    calls = [0]

    def wrapped(state, *args):
        i = calls[0]
        calls[0] += 1
        if i == 0:
            with FlopCounterMode(display=False) as counter:
                m = step(state, *args)
            flops.append(counter.get_total_flops())
            return m
        if i == at:
            prof.start()
        m = step(state, *args)
        if i == at + steps - 1:
            prof.stop()
        return m

    trainer.train_step = wrapped
    try:
        trainer.run_epoch(epoch)
    finally:
        trainer.train_step = step
    return prof.summary(steps, "train"), flops[0]


def run(ctx: common.Context) -> Dict:
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    c, tr = ctx.config, ctx.traffic
    dual = tr["variant"] == "proposed"
    data = common.data_spec(c, ctx.seed)
    cfg = common.train_config(c, tr["variant"], ctx.seed, ctx.workdir)
    first, checked = tr["first_epoch"], tr["checked_steps"]
    spans = {}

    ctx.log("building the trainer (data generation, decode, upload, nets)")
    t0 = time.perf_counter()
    task = SyntheticTask(root=cfg.data.root, tempmask_folder=cfg.data.tempmask_folder,
                         **common.task_options(data))
    trainer = Trainer(cfg, task=task, device=ctx.device)
    trainer.label_cases = set(task.clean_case_ids())
    spans["setup.data"] = time.perf_counter() - t0
    sds = weights.make(c["model"], ctx.seed ^ 0x5EED, ctx.device, len(trainer.state.nets))
    for net, sd in zip(trainer.state.nets, sds):
        net.load_state_dict(sd)
    spe = trainer.train_pipe.steps_per_epoch(cfg.data.batch_size)
    if spe < checked:
        raise ValueError(f"an epoch of {spe} steps holds fewer than the {checked} checked")
    recorder, answers = FirstSteps(trainer, checked), EpochAnswers(trainer)
    ctx.log(f"warm-up epoch {first} ({checked} steps, its case evaluation and refresh "
            "recorded for the check)")
    t0 = time.perf_counter()
    trainer.run_epoch(first)
    common.sync(ctx.device)
    recorder.detach()
    evaluated = answers.finish(first)
    spans["setup.warm"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - ctx.t_process
    ctx.log(f"setup {setup_s:.3f} s (trainer {spans['setup.data']:.3f}, warm-up "
            f"{spans['setup.warm']:.3f})")

    rows: List[Dict] = []

    def epoch(e):
        rows.append(trainer.run_epoch(e))
        common.sync(ctx.device)

    times = stats.whole_epochs(epoch, first + 1, ctx.seconds)
    ctx.log(f"window: {len(times)} whole epochs, {sum(times):.3f} s: {times}")
    profile, flops = None, None
    if ctx.trace:
        profile, flops = profiled_epoch(trainer, first + 1 + len(times), tr["profile_steps"],
                                        ctx.device)
    peak = common.memory_peak(ctx.device)
    ctx.log(f"device memory peak {peak} B")

    del trainer, task
    recorder.trainer = recorder.step = recorder.named = recorder.start = None
    common.free_device(ctx.device)
    ctx.log("reference: the checked steps in float32")
    ref = ref_steps.readings(c, data, dual, sds, ctx.seed, first, checked, ctx.device)
    numbers = checks.train_numbers(recorder.readings, ref)
    ctx.log("reference: the warm-up epoch's case evaluation and refresh in float32")
    numbers.update(epoch_reference(c, data, evaluated, ctx.device))
    diag = checks.train_diagnostics(recorder.readings, ref)
    ctx.log("not compared: " + ", ".join(f"{k} {v:.6g}" for k, v in diag.items()
                                          if isinstance(v, float)))
    return {
        "e2e": {"epoch_s": sum(times) / len(times), "setup_s": setup_s},
        "attempted": len(times), "failed": 0, "numbers": numbers,
        "memory_peak_bytes": peak, "profile": profile,
        "record": {"spans": spans, "rows": rows, "steps_per_epoch": spe, "flops": flops,
                   "profile": profile, "config": c, "traffic": tr},
    }
