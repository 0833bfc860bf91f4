"""The port's spans and counters (``aide_tpu_torch.core.trace``): totals,
call counts, nesting and snapshot differences; ``record_function`` entered
under a profiler alone; device time and idle time by program span on
hand-made profiler events; and the spans of a tiny CPU ``Trainer`` epoch,
co-teaching and supervised, under ``torch.profiler`` and in its history
row."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------ the recorder ------------------------------


def test_span_totals_calls_nesting_and_delta():
    before = trace.totals()
    with trace.span("t.outer"):
        for _ in range(3):
            with trace.span("t.inner"):
                time.sleep(0.002)
    changed = trace.delta(before)
    assert set(changed) == {"t.outer", "t.inner"}
    assert changed["t.inner"][1] == 3 and changed["t.outer"][1] == 1
    # a child's time lies inside its parent's; each span's seconds are its own
    assert 0.006 <= changed["t.inner"][0] <= changed["t.outer"][0] == trace.last("t.outer")
    assert 0.002 <= trace.last("t.inner") <= changed["t.inner"][0]
    assert trace.seconds(changed, "t.inner", "t.outer", "t.never") == pytest.approx(
        changed["t.inner"][0] + changed["t.outer"][0])
    # a second stretch reads only its own calls
    middle = trace.totals()
    with trace.span("t.inner"):
        pass
    assert {k: v[1] for k, v in trace.delta(middle).items()} == {"t.inner": 1}
    assert trace.delta(before, middle) == changed
    assert trace.last("t.never") is None


def test_span_closes_on_an_exception():
    before = trace.totals()
    with pytest.raises(ValueError):
        with trace.span("t.raises"):
            raise ValueError("inside")
    assert trace.delta(before)["t.raises"][1] == 1


def test_marks_keep_the_latest_snapshot():
    assert trace.marked("t.never") is None
    trace.mark("t.mark")
    with trace.span("t.between"):
        pass
    first = trace.marked("t.mark")
    trace.mark("t.mark")
    assert {k: v[1] for k, v in trace.delta(first, trace.marked("t.mark")).items()} == {
        "t.between": 1}


def test_counters_and_their_delta():
    before = trace.totals()
    trace.add("t.count")
    trace.add("t.count", 4)
    assert trace.delta(before) == {"t.count": 5}
    assert trace.totals()["t.count"] - before.get("t.count", 0) == 5
    again = trace.totals()
    assert trace.delta(again) == {}


def test_record_function_entered_under_a_profiler_alone(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with trace.span("t.quiet"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("t.loud"):
            with trace.span("t.loud.child"):
                torch.ones(4).sum()
    assert entered == ["t.loud", "t.loud.child"]
    ann = {e.name: e.time_range for e in prof.events() if e.is_user_annotation}
    assert ann["t.loud"].start <= ann["t.loud.child"].start
    assert ann["t.loud.child"].end <= ann["t.loud"].end
    with trace.span("t.quiet"):
        pass
    assert entered == ["t.loud", "t.loud.child"]


# --------------------------- device time by span ---------------------------


def _cpu(name, start, end, kernels=(), annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CPU, is_user_annotation=annotation,
                           is_async=False,
                           kernels=[SimpleNamespace(duration=d) for d in kernels])


def _kernel(name, start, end, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA, is_user_annotation=annotation,
                           is_async=False, kernels=[])


def test_device_time_goes_to_the_span_that_launched_it():
    """Two spans, A then B, on the host; A's op launches a 30 us kernel
    that runs on the device only after A has closed, inside B's host
    interval: it counts for A. An op outside both spans, a kernel linked
    to a span itself, and a kernel linked to no op at all; idle stretches
    labelled by the span open on the host at their middles."""
    names = {"A", "B", "B.child"}
    events = [
        _cpu("A", 0.0, 10.0, annotation=True),
        _cpu("aten::conv", 2.0, 4.0, kernels=[30.0]),
        _kernel("conv_kernel", 50.0, 80.0),
        _cpu("B", 20.0, 100.0, kernels=[5.0], annotation=True),
        _cpu("B.child", 30.0, 60.0, annotation=True),
        _cpu("aten::add", 40.0, 41.0, kernels=[10.0]),
        _kernel("add_kernel", 85.0, 95.0),
        _kernel("b_kernel", 95.0, 100.0),
        _cpu("aten::mul", 110.0, 112.0, kernels=[20.0]),
        _kernel("mul_kernel", 120.0, 140.0),
        _kernel("memset", 140.0, 150.0),  # linked to no host op
        _cpu("ProfilerStep#1", 0.0, 150.0, annotation=True),  # not a program span
        _kernel("B", 85.0, 100.0, annotation=True),  # the device-side annotation
    ]
    got = trace.by_span(events, names)
    assert got["device_ms"] == pytest.approx(
        {"A": 0.030, "B.child": 0.010, "B": 0.005, trace.OUTSIDE: 0.030})
    assert got["kernel_ms"] == pytest.approx(0.075)
    assert got["busy_ms"] == pytest.approx(0.075)
    # the window is 0-150 us: idle 0-50 (middle 25, in B, not yet in its
    # child at 30), 80-85 (middle 82.5, in B), 100-120 (middle 110, no span)
    assert got["idle_ms"] == pytest.approx({"B": 0.055, trace.OUTSIDE: 0.020})


def test_device_and_idle_by_span_on_intervals():
    spans = [("outer", 0.0, 100.0), ("inner", 10.0, 20.0), ("inner", 50.0, 60.0)]
    launches = [(15.0, 7.0), (55.0, 3.0), (30.0, 1.0), (200.0, 2.0), (10.0, 1.0)]
    assert trace.device_by_span(spans, launches) == {
        "inner": 11.0, "outer": 1.0, trace.OUTSIDE: 2.0}
    kernels = [(5.0, 12.0), (11.0, 14.0), (40.0, 52.0)]
    # gaps 0-5 (outer), 14-40 (middle 27: outer), 52-70 (middle 61: outer)
    assert trace.idle_by_span(spans, kernels, 0.0, 70.0) == {"outer": 49.0}
    assert trace.idle_by_span(spans, kernels, 55.0, 58.0) == {"inner": 3.0}


def test_by_span_without_kernels_reads_no_device():
    events = [_cpu("A", 0.0, 10.0, annotation=True), _cpu("aten::add", 1.0, 2.0)]
    assert trace.by_span(events, {"A"}) == {"device_ms": {}, "idle_ms": {},
                                            "kernel_ms": 0.0, "busy_ms": 0.0}


# ------------------------- a tiny trainer's spans -------------------------

STEP_CHILDREN = {"step.forward", "step.backward", "step.optimizer", "step.metrics"}


@pytest.fixture(scope="module", params=["proposed", "comparison"])
def trainer(request, tmp_path_factory):
    """A FuseUNet-4 trainer at 32 px on 4 cases of 4 slices, batch 4 (4
    steps an epoch), co-teaching or supervised, after one epoch."""
    tmp = tmp_path_factory.mktemp(request.param)
    cfg = TrainConfig()
    cfg.model = ModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    d = cfg.data
    d.task, d.variant, d.root, d.tempmask_folder = "synthetic", request.param, str(tmp), "tm"
    d.img_size, d.batch_size, d.eval_batch_size, d.num_tta_views = 32, 4, 4, 2
    cfg.checkpoint_dir, cfg.history_dir = str(tmp / "ckpt"), str(tmp / "hist")
    task = SyntheticTask(root=str(tmp), tempmask_folder="tm", two_modal=True, num_cases=4,
                         slices_per_case=4, size=32, clean_cases=1, num_test_cases=1, seed=5)
    before = trace.totals()
    tr = Trainer(cfg, task=task, device="cpu")
    built = trace.delta(before)
    assert {k: v[1] for k, v in built.items()} == {
        "setup.decode": 1, "setup.upload": 1, "setup.nets": 1}
    assert trace.last("setup.decode") == built["setup.decode"][0]
    tr.run_epoch(0)
    return tr


def test_epoch_row_reads_the_spans(trainer):
    before = trace.totals()
    row = trainer.run_epoch(1)
    spent = trace.delta(before)
    assert row is trainer.history[-1]
    # the JAX trainer's keys, no more
    assert {k for k in row if k.startswith("time")} == {
        "time_train", "time_test", "time_cases", "time_ckpt", "time_refresh",
        "time_cases_fetch", "time_cases_host", "time"}
    assert row["time_train"] == round(trace.last("epoch.train"), 2)
    for phase in ("train", "test", "cases", "ckpt", "refresh"):
        assert row[f"time_{phase}"] == round(spent[f"epoch.{phase}"][0], 2)
    assert row["time"] == trace.last("epoch") == spent["epoch"][0]
    assert row["time_cases_fetch"] == round(
        spent["cases.dispatch"][0] + spent["cases.fetch"][0], 2)
    assert row["time_cases_host"] == round(spent["cases.cc"][0] + spent["cases.score"][0], 2)
    steps = trainer.train_pipe.steps_per_epoch(4)
    # the feed is entered once more than the steps: its last call finds no batch
    assert spent["train.data"][1] == steps + 1 and spent["train.step"][1] == steps
    assert spent["train.data"][0] + spent["train.step"][0] <= spent["epoch.train"][0]
    if trainer.dual:
        assert spent["refresh.write"][1] >= 1 and spent["refresh.sync"][1] == 1
        assert spent["step.views"][1] == steps
    else:
        assert "refresh.write" not in spent and "step.views" not in spent
    for child in STEP_CHILDREN:
        assert spent[child][1] == steps
    # the epoch's end is marked: the marks around it give its spans
    assert trace.delta(trace.marked(("epoch", 1)), trace.marked(("epoch", 2))) == spent


def test_epoch_spans_under_a_profiler(trainer):
    """The annotations of a profiled epoch: ``train.step`` once a step with
    its children inside it, ``train.data`` outside every step."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(2)
    ann = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.is_user_annotation]
    steps = [a for a in ann if a[0] == "train.step"]
    assert len(steps) == trainer.train_pipe.steps_per_epoch(4)
    children = STEP_CHILDREN | ({"step.views"} if trainer.dual else set())
    for name, a, z in ann:
        if name in children:
            assert sum(s[1] <= a and z <= s[2] for s in steps) == 1, name
        if name == "train.data":
            assert not any(s[1] < z and a < s[2] for s in steps)
    for _, a, z in steps:
        inside = {n for n, b, y in ann if a <= b and y <= z and n != "train.step"}
        assert children <= inside
    (epoch,) = [a for a in ann if a[0] == "epoch"]
    for name in ("epoch.train", "epoch.test", "epoch.cases", "epoch.ckpt", "epoch.refresh"):
        (span,) = [a for a in ann if a[0] == name]
        assert epoch[1] <= span[1] and span[2] <= epoch[2]
    # on the CPU no kernel reaches the device: no device time to attribute
    got = trace.by_span(prof.events())
    assert got["device_ms"] == {} and got["busy_ms"] == 0.0


# ------------------ the refresh's and the gate's counters ------------------


def test_refresh_and_gate_counters(tmp_path):
    """A single-modal UNet pair under the kidney knobs (the refresh that
    skips an empty prediction, the ascending gate) on 6 cases of 2 slices,
    case00 labeled and case03 predicted background by both nets: over 3
    epochs ``refresh.images`` and ``refresh.skipped_empty`` add up to the
    selected, non-labeled images, the latter to those of the empty
    predictions, and ``ckpt.gate_closed`` counts the epochs the gate held
    closed."""
    import numpy as np

    cfg = TrainConfig()
    cfg.model = ModelConfig(name="unet", base_width=4, compute_dtype="float32")
    d = cfg.data
    d.task, d.variant, d.root, d.tempmask_folder = "synthetic", "proposed", str(tmp_path), "tm"
    d.img_size, d.batch_size, d.eval_batch_size, d.num_tta_views = 32, 4, 4, 2
    cfg.coteach.update_percent = 0.5  # the worst 3 of 6 cases a net
    cfg.coteach.refresh_skip_empty = True
    cfg.ascending_checkpoint_gate = True
    cfg.checkpoint_dir, cfg.history_dir = str(tmp_path / "ckpt"), str(tmp_path / "hist")
    task = SyntheticTask(root=str(tmp_path), tempmask_folder="tm", two_modal=False, num_cases=6,
                         slices_per_case=2, size=32, clean_cases=1, num_test_cases=1, seed=5)
    tr = Trainer(cfg, task=task, device="cpu")
    tr.label_cases = {"case00"}
    rows = tr.train_pipe.case_indices("case03")
    predict_all = tr.predict_all

    def planted(state, data, idx):
        out = predict_all(state, data, idx)
        hit = torch.from_numpy(np.isin(np.asarray(idx), rows))
        return out.masked_fill(hit[:, None, :, None, None], 0)

    tr.predict_all = planted
    closed = 0
    for epoch in range(3):
        before = trace.totals()
        tr.run_epoch(epoch)
        spent = trace.delta(before)
        owed = {"refresh.images": 0, "refresh.skipped_empty": 0}
        for e, net, selected, rewritten in tr.refresh_log:
            if e != epoch:
                continue
            assert "case03" in selected and "case03" not in rewritten
            for case in selected:
                if case in tr.label_cases:
                    continue
                n = len(tr.train_pipe.case_indices(case))
                owed["refresh.images" if case in rewritten else "refresh.skipped_empty"] += n
        assert owed["refresh.skipped_empty"] >= 4  # case03's 2 slices, both nets
        assert {k: spent.get(k, 0) for k in owed} == owed
        # the gate opens once and stays open: an epoch it leaves closed counts
        closed += not tr.ascending
        assert spent.get("ckpt.gate_closed", 0) == (0 if tr.ascending else 1)
    assert closed >= 1  # epoch 0 never opens it
