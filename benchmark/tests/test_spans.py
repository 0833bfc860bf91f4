"""The per-layer metrics read from the port's spans, on the CPU: a tiny
``--trace 1`` run of each cell reads them as numbers, in the bounds the
epoch's own phases set; the window is the difference of the port's marks
around the rows' epochs; a program without the spans (no
``aide_tpu_torch.core.trace``) or without those marks reads None, not an
error."""

from __future__ import annotations

import sys

import pytest

from benchmark import manifest as mf
from benchmark import spans
from benchmark.tests import tiny

SPAN_METRICS = {
    "chaos_coteach_epoch": {"setup.decode_s", "train.data_ms", "train.host_ms", "eval.cc_s",
                            "refresh.write_s", "ckpt.backup_s"},
    "chaos_supervised_epoch": {"setup.decode_s", "train.data_ms", "train.host_ms",
                               "eval.cc_s"},
}


def test_the_manifest_lists_each_span_metric_where_its_reader_reads():
    m = mf.load()
    for cell, names in SPAN_METRICS.items():
        listed = {x["name"] for x in mf.cell_metrics(m, "per_layer", cell)}
        assert names <= listed
    for x in m["per_layer"]:
        if x["name"] in SPAN_METRICS["chaos_coteach_epoch"]:
            assert x["source"] == "program_span" and x["better"] == "lower"


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_tiny_run_reads_the_span_metrics(tmp_path, cell):
    root = str(tmp_path)
    m = tiny.make_tree(root)
    res = tiny.run_tiny(m, cell, root, trace=True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert SPAN_METRICS[cell] <= set(got)
    for name in SPAN_METRICS[cell]:
        assert isinstance(got[name], float) and got[name] >= 0.0, name
    # the feed and the steps lie inside the train phase; the decode inside
    # the build; the host's CC inside the epoch's evaluation
    assert got["train.data_ms"] + got["train.host_ms"] <= got["train.step_ms"] + 10.0
    assert 0.0 < got["setup.decode_s"] <= got["setup.data_s"]
    assert got["eval.cc_s"] <= got["epoch.eval_s"] + 0.01
    if cell == "chaos_coteach_epoch":
        assert got["refresh.write_s"] > 0.0
        assert got["refresh.write_s"] + got["ckpt.backup_s"] <= got["epoch.ckpt_refresh_s"] + 0.02


@pytest.mark.parametrize("name", sorted(SPAN_METRICS["chaos_coteach_epoch"]))
def test_a_program_without_the_spans_reads_none(monkeypatch, name):
    rows = [{"epoch": 999_998, "time_train": 1.0, "time": 2.2},
            {"epoch": 999_999, "time_train": 1.0, "time": 2.2}]
    record = {"rows": rows, "steps_per_epoch": 4, "spans": {"setup.data": 3.0}}
    if name != "setup.decode_s":
        # the port has spans, but no epoch of these numbers was marked
        assert mf.reader(name)(record) is None
    # the parent's port has no core.trace: its import fails
    import aide_tpu_torch.core

    monkeypatch.delattr(aide_tpu_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "aide_tpu_torch.core.trace", None)
    assert mf.reader(name)(record) is None


def test_the_window_is_the_marks_around_the_rows():
    from aide_tpu_torch.core import trace

    rows = [{"epoch": 777_001}, {"epoch": 777_002}]
    record = {"rows": rows, "steps_per_epoch": 2}
    trace.mark(("epoch", 777_000))
    for _ in rows:
        with trace.span("epoch"):
            with trace.span("cases.cc"):
                pass
        trace.mark(("epoch", _["epoch"]))
    spent = spans.window(record)
    assert {k: v[1] for k, v in spent.items()} == {"epoch": 2, "cases.cc": 2}
    assert spans.per_epoch_s(record, "cases.cc") == pytest.approx(spent["cases.cc"][0] / 2)
    assert spans.per_step_ms(record, "cases.cc") == pytest.approx(
        1e3 * spent["cases.cc"][0] / 4)
    assert spans.per_epoch_s(record, "ckpt.backup") == 0.0
    # marks that hold another count of epochs than the rows read nothing:
    # a later trainer's mark of the epoch before the window
    trace.mark(("epoch", 777_000))
    assert spans.window(record) is None
