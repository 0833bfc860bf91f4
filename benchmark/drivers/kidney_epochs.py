"""Whole epochs of the port's ``Trainer.run_epoch`` under AIDE's kidney
protocol.

The flow of ``drivers/epochs.py`` (its ``FirstSteps``, ``EpochAnswers``,
``profiled_epoch`` and ``epoch_reference``): set-up builds one Trainer and
loads the seed's weights, runs the warm-up epoch ``traffic["first_epoch"]``
with its first steps, case evaluation and refresh recorded for the check,
then the window's whole epochs, and with ``--trace 1`` one more epoch
profiled. The TrainConfig also takes the protocol's knobs that
``common.train_config`` leaves out (``sharpen_mode``, ``temperature``,
``tta_bn``, ``ascending_checkpoint_gate``), and the checked steps are held
to ``reference.kidney``, which takes the same knobs. An epoch whose
refresh rewrote no image fails the run, as its refresh log tells.
"""

from __future__ import annotations

import time
from typing import Dict, List

from benchmark import checks, common, stats, weights
from benchmark.drivers.epochs import EpochAnswers, FirstSteps, epoch_reference, profiled_epoch
from benchmark.reference import kidney as ref_kidney


def train_config(config: Dict, variant: str, seed: int, workdir: str):
    """``common.train_config`` with the kidney protocol's knobs."""
    cfg = common.train_config(config, variant, seed, workdir)
    cfg.coteach.sharpen_mode = config["sharpen_mode"]
    cfg.coteach.temperature = float(config["temperature"])
    cfg.coteach.tta_bn = config["tta_bn"]
    cfg.ascending_checkpoint_gate = bool(config["ascending_checkpoint_gate"])
    return cfg


def refreshed_images(trainer, epoch: int) -> int:
    """Images whose working labels the refresh of ``epoch`` rewrote, over
    both nets: the slices of the refresh log's rewritten cases, which
    leave out the labeled cases and those skipped as empty."""
    pipe = trainer.train_pipe
    return sum(len(pipe.case_indices(c)) for e, _, _, rewritten in trainer.refresh_log
               if e == epoch for c in rewritten)


def run(ctx: common.Context) -> Dict:
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    c, tr = ctx.config, ctx.traffic
    if tr["variant"] != "proposed":
        raise ValueError("the kidney protocol is the co-teaching trainer's")
    data = common.data_spec(c, ctx.seed)
    cfg = train_config(c, tr["variant"], ctx.seed, ctx.workdir)
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

    def epoch(e):
        row = trainer.run_epoch(e)
        common.sync(ctx.device)
        images = refreshed_images(trainer, e)
        if not images:
            raise RuntimeError(f"epoch {e}'s refresh rewrote no image: the window would time "
                               "no refresh")
        return row, images

    ctx.log(f"warm-up epoch {first} ({checked} steps, its case evaluation and refresh "
            "recorded for the check)")
    t0 = time.perf_counter()
    _, images = epoch(first)
    recorder.detach()
    evaluated = answers.finish(first)
    spans["setup.warm"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - ctx.t_process
    ctx.log(f"setup {setup_s:.3f} s (trainer {spans['setup.data']:.3f}, warm-up "
            f"{spans['setup.warm']:.3f}); the warm-up refresh rewrote {images} images")

    rows: List[Dict] = []
    refreshed: List[int] = []

    def window_epoch(e):
        row, images = epoch(e)
        rows.append(row)
        refreshed.append(images)

    times = stats.whole_epochs(window_epoch, first + 1, ctx.seconds)
    ctx.log(f"window: {len(times)} whole epochs, {sum(times):.3f} s: {times}; images "
            f"refreshed {refreshed}")
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
    ref = ref_kidney.readings(c, data, True, sds, ctx.seed, first, checked, ctx.device)
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
