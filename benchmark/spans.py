"""The window's spans of the port (``aide_tpu_torch.core.trace``), for the
per-layer metrics that read them. The port marks the end of each epoch
with a snapshot of its span totals (``trace.mark(("epoch", n))``, n the
history row's ``epoch``); the window's whole epochs are the difference
between the mark before the first of the record's rows and the mark of
the last. Each function gives None where the port has no spans (a
program from before them) or the marks do not hold exactly the rows'
epochs."""

from __future__ import annotations

from typing import Dict, Optional


def window(record: Dict) -> Optional[Dict]:
    """The spans closed in the window's epochs, ``{name: (seconds, calls)}``."""
    rows = record.get("rows")
    if not rows:
        return None
    try:
        from aide_tpu_torch.core import trace
    except ImportError:
        return None
    before = trace.marked(("epoch", rows[0]["epoch"] - 1))
    after = trace.marked(("epoch", rows[-1]["epoch"]))
    if before is None or after is None:
        return None
    spent = trace.delta(before, after)
    if spent.get("epoch", (0.0, 0))[1] != len(rows):
        return None
    return spent


def per_epoch_s(record: Dict, name: str) -> Optional[float]:
    """Seconds of the span ``name`` an epoch of the window (0 where it
    never closed)."""
    spent = window(record)
    if spent is None:
        return None
    return spent.get(name, (0.0, 0))[0] / len(record["rows"])


def per_step_ms(record: Dict, name: str) -> Optional[float]:
    """Milliseconds of the span ``name`` a train step of the window."""
    s = per_epoch_s(record, name)
    return None if s is None else 1e3 * s / record["steps_per_epoch"]
