"""The reader of ``train.graph_share`` on synthetic records: the port's
marks around the window's epochs, its ``train.step`` spans and its graph
counters (``aide_tpu_torch.core.trace``), as a replaying, a part-eager and
an older program leave them."""

from __future__ import annotations

import sys

import pytest

from benchmark import manifest as mf


def _window(epoch0, steps, counters):
    """Marks around two epochs of ``steps`` train steps each, every step
    adding one to the counter ``counters[i]``; the record of those rows."""
    from aide_tpu_torch.core import trace

    rows = [{"epoch": epoch0 + 1}, {"epoch": epoch0 + 2}]
    trace.mark(("epoch", epoch0))
    for row in rows:
        with trace.span("epoch"):
            for i in range(steps):
                with trace.span("train.step"):
                    if counters:
                        trace.add(counters[i % len(counters)])
        trace.mark(("epoch", row["epoch"]))
    return {"rows": rows, "steps_per_epoch": steps}


@pytest.mark.parametrize("counters, share", [
    (["train.graph_replays"], 100.0),
    (["train.graph_replays", "train.graph_replays", "train.graph_replays",
      "train.graph_eager"], 75.0),
    (["train.graph_eager"], 0.0),
    (["train.graph_captures", "train.graph_replays"], 50.0),
])
def test_the_share_is_the_replays_over_the_steps(counters, share):
    record = _window(555_000 + 10 * len(counters), 8, counters)
    assert mf.reader("train.graph_share")(record) == pytest.approx(share)


def test_a_program_without_the_counters_reads_none(monkeypatch):
    record = _window(556_000, 4, [])
    assert mf.reader("train.graph_share")(record) is None
    # the marks do not hold the rows' epochs
    assert mf.reader("train.graph_share")({"rows": [{"epoch": 556_900}],
                                           "steps_per_epoch": 4}) is None
    import aide_tpu_torch.core

    monkeypatch.delattr(aide_tpu_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "aide_tpu_torch.core.trace", None)
    assert mf.reader("train.graph_share")(record) is None


def test_the_manifest_lists_the_share_where_the_step_replays():
    m = mf.load()
    (entry,) = [x for x in m["per_layer"] if x["name"] == "train.graph_share"]
    assert entry["layer"] == "train step" and entry["moves"] == "epoch_s"
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert set(entry["workloads"]) == {"chaos_coteach_epoch", "chaos_supervised_epoch"}
