"""The reader of ``refresh.image_ms`` on synthetic records: the port's marks
around the window's epochs, its ``refresh.write`` spans and its counter
``refresh.images`` (``aide_tpu_torch.core.trace``), as a counting and an
older program leave them."""

from __future__ import annotations

import sys

import pytest

from benchmark import manifest as mf


def _window(epoch0, writes, images, clock):
    """Marks around two epochs, each with ``writes`` spans ``refresh.write``
    of 5 ms on the fake ``clock`` and, where ``images`` is set, that many
    images counted; the record of those rows."""
    from aide_tpu_torch.core import trace

    rows = [{"epoch": epoch0 + 1}, {"epoch": epoch0 + 2}]
    trace.mark(("epoch", epoch0))
    for row in rows:
        with trace.span("epoch"):
            for _ in range(writes):
                with trace.span("refresh.write"):
                    clock[0] += 0.005
            if images:
                trace.add("refresh.images", images)
        trace.mark(("epoch", row["epoch"]))
    return {"rows": rows, "steps_per_epoch": 4}


@pytest.fixture
def clock(monkeypatch):
    from aide_tpu_torch.core import trace

    now = [1000.0]
    monkeypatch.setattr(trace, "_clock", lambda: now[0])
    return now


@pytest.mark.parametrize("writes, images, ms", [(60, 60, 5.0), (30, 60, 2.5), (7, 231, 35 / 231)])
def test_the_ms_are_the_write_span_over_the_images(clock, writes, images, ms):
    record = _window(557_000 + writes, writes, images, clock)
    assert mf.reader("refresh.image_ms")(record) == pytest.approx(ms)


def test_a_program_without_the_counter_reads_none(clock, monkeypatch):
    record = _window(558_000, 6, 0, clock)
    assert mf.reader("refresh.image_ms")(record) is None
    # the marks do not hold the rows' epochs
    assert mf.reader("refresh.image_ms")({"rows": [{"epoch": 558_900}],
                                          "steps_per_epoch": 4}) is None
    counted = _window(558_100, 6, 6, clock)
    assert mf.reader("refresh.image_ms")(counted) == pytest.approx(5.0)
    import aide_tpu_torch.core

    monkeypatch.delattr(aide_tpu_torch.core, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "aide_tpu_torch.core.trace", None)
    assert mf.reader("refresh.image_ms")(counted) is None


def test_the_manifest_lists_the_metric_where_a_refresh_counts():
    m = mf.load()
    (entry,) = [x for x in m["per_layer"] if x["name"] == "refresh.image_ms"]
    assert entry["layer"] == "checkpoint and refresh" and entry["moves"] == "epoch_s"
    assert entry["unit"] == "ms" and entry["better"] == "lower"
    assert entry["source"] == "program_span"
    assert entry["workloads"] == ["chaos_coteach_epoch", "kidney_coteach_epoch"]
