"""The port's spans and counters: where the host's time goes, and, under a
profiler, on the device trace's clock.

``span(name)`` times a block on the host (``time.perf_counter``) and adds
its seconds and one call to the process's totals under ``name``. While a
``torch.profiler`` records, it also enters ``record_function(name)``, so the
block shows in the trace as a user annotation, nested in its parent span,
beside the kernels it launched; without a profiler it never does (entering
one costs several times the whole span). ``add(name, n)`` keeps integer
counters. ``totals()`` is a snapshot of both; ``delta(before)`` what
changed since an earlier one, so a reader takes its own stretch however
many trainers the process builds; ``mark(label)`` keeps a snapshot for a
later reader (the trainer marks each epoch's end). ``last(name)`` is the
seconds of the latest closed span of that name. Everything stays in
memory; nothing is written. Spans are opened from one thread; span and
counter names are apart.

The names, at the layer boundaries:

* set-up (``Trainer.__init__``): ``setup.decode`` (manifests and both
  slice pipelines), ``setup.upload`` (the data to the card),
  ``setup.nets`` (the nets built, moved to the card, the optimizer);
* an epoch (``Trainer.run_epoch``): ``epoch`` around ``epoch.train``,
  ``epoch.test``, ``epoch.cases``, ``epoch.ckpt``, ``epoch.refresh``;
* the train loop: ``train.data`` (the next batch, its move to the card,
  the augment and view draws) and ``train.step``, opened by the step
  function itself, around ``step.views`` (the TTA pseudo-labels),
  ``step.forward``, ``step.backward``, ``step.optimizer`` (the gradient
  all-reduce and the update) and ``step.metrics``;
* case evaluation (``evaluation/case_eval.py``, the fused test pass):
  ``cases.dispatch``, ``cases.fetch`` (the wait for the labels),
  ``cases.cc`` (the largest component on the host), ``cases.score``;
* checkpoint and refresh: ``ckpt.snapshot``, ``ckpt.backup`` (the best
  epoch's tempmask copy), ``refresh.write`` (a case's tempmask files),
  ``refresh.sync`` (the changed labels to the card);
* the counter ``warp.launches``: the TTA warp kernel's launches, counted
  where ``ops.cuda_warp.launch`` is called (a replayed train step's graph
  launches its warp kernels without that call: a device trace counts
  them);
* the counter ``upsample.launches``: the decoders' 2x upsample kernels'
  launches, forward and backward, counted where
  ``ops.cuda_upsample`` launches them. Under a replayed train step that
  counts the host's calls, that is the capture's: a replay launches the
  graph's upsample kernels without a call (a device trace counts them);
* the counters ``train.graph_replays``, ``train.graph_captures`` and
  ``train.graph_eager`` (``engine.graphs``): one a train step, as it ran.
  A replayed step closes ``train.step`` and no ``step.*`` span.
* the counters ``refresh.images`` and ``refresh.skipped_empty``
  (``Trainer._refresh_labels``, over both nets): the images whose working
  labels a refresh rewrote, and those it left alone because their case's
  prediction was empty (``coteach.refresh_skip_empty``); and
  ``ckpt.gate_closed``: one an epoch that the ascending checkpoint gate
  held closed (``Trainer._maybe_checkpoint``).

``by_span(events)`` reads a finished profiler's events: each kernel's
device time under the innermost span open when the host op that launched
it started, and each idle stretch of the device under the innermost span
open at its middle.
"""

from __future__ import annotations

import time
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import torch

# name: [seconds, calls] of the closed spans; name: count of the counters
_SPANS: Dict[str, list] = {}
_LAST: Dict[str, float] = {}
_COUNTS: Dict[str, int] = {}
# label: the snapshot ``mark`` took under it last
_MARKS: Dict[Hashable, Dict[str, object]] = {}

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter

# the label of device time that no program span accounts for
OUTSIDE = "(outside spans)"


class span:
    """``with span(name):`` adds the block's host seconds and a call to the
    totals under ``name``. A class rather than a generator: entering it
    builds no frame."""

    __slots__ = ("name", "_t0", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self._annotation = None

    def __enter__(self) -> "span":
        if _profiling():
            self._annotation = torch.autograd.profiler.record_function(self.name)
            self._annotation.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        dt = _clock() - self._t0
        total = _SPANS.get(self.name)
        if total is None:
            _SPANS[self.name] = [dt, 1]
        else:
            total[0] += dt
            total[1] += 1
        _LAST[self.name] = dt
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        return False


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def totals() -> Dict[str, object]:
    """A snapshot: ``{span: (seconds, calls)}`` and ``{counter: count}``."""
    out: Dict[str, object] = {k: (v[0], v[1]) for k, v in _SPANS.items()}
    out.update(_COUNTS)
    return out


def delta(before: Dict[str, object], after: Optional[Dict[str, object]] = None
          ) -> Dict[str, object]:
    """What changed from the snapshot ``before`` to ``after`` (default: now):
    the spans closed in between as ``(seconds, calls)``, the counters'
    increase; names that did not move are left out."""
    after = totals() if after is None else after
    out: Dict[str, object] = {}
    for name, now in after.items():
        then = before.get(name)
        if isinstance(now, tuple):
            spent, calls = then or (0.0, 0)
            if now[1] != calls:
                out[name] = (now[0] - spent, now[1] - calls)
        elif now != (then or 0):
            out[name] = now - (then or 0)
    return out


def seconds(changed: Dict[str, object], *names: str) -> float:
    """The summed seconds of ``names`` in a ``delta`` (0 for a span that did
    not close)."""
    return sum((changed[n][0] for n in names if n in changed), 0.0)


def last(name: str) -> Optional[float]:
    """Seconds of the latest closed span ``name``; None before the first."""
    return _LAST.get(name)


def mark(label: Hashable) -> None:
    """Keep a snapshot (``totals()``) under ``label``, in place of the one a
    former mark of that label kept. ``Trainer.run_epoch`` marks the end of
    each epoch under ``("epoch", n)``, n its history row's ``epoch``, so a
    reader takes the spans of epochs a+1..b as ``delta(marked(("epoch",
    a)), marked(("epoch", b)))``."""
    _MARKS[label] = totals()


def marked(label: Hashable) -> Optional[Dict[str, object]]:
    """The snapshot the latest ``mark(label)`` kept; None before any."""
    return _MARKS.get(label)


Interval = Tuple[str, float, float]


def _innermost(spans: Sequence[Interval], times: Sequence[float]) -> List[str]:
    """For each of the ascending ``times``, the name of the span open at it
    that started last (the innermost, as spans nest), or ``OUTSIDE``."""
    order = sorted(spans, key=lambda s: s[1])
    names, active, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            active.append(order[i])
            i += 1
        active = [s for s in active if s[2] >= t]
        names.append(max(active, key=lambda s: s[1])[0] if active else OUTSIDE)
    return names


def device_by_span(spans: Sequence[Interval], launches: Sequence[Tuple[float, float]]
                   ) -> Dict[str, float]:
    """Device microseconds by program span: each ``(launch_us, device_us)``
    counted under the innermost span open at its launch on the host,
    wherever its kernel ran later on the device."""
    launches = sorted(launches)
    out: Dict[str, float] = {}
    for name, (_, us) in zip(_innermost(spans, [t for t, _ in launches]), launches):
        out[name] = out.get(name, 0.0) + us
    return out


def idle_by_span(spans: Sequence[Interval], kernels: Sequence[Tuple[float, float]],
                 start: float, end: float) -> Dict[str, float]:
    """Idle device microseconds in [start, end] (no kernel of ``kernels``,
    (start_us, end_us) intervals, running) by the innermost program span
    open on the host at each idle stretch's middle."""
    gaps, at = [], start
    for a, z in sorted(k for k in kernels if k[1] > start and k[0] < end):
        if a > at:
            gaps.append((at, a))
        at = max(at, z)
    if end > at:
        gaps.append((at, end))
    out: Dict[str, float] = {}
    for name, (a, z) in zip(_innermost(spans, [0.5 * (a + z) for a, z in gaps]), gaps):
        out[name] = out.get(name, 0.0) + (z - a)
    return out


def by_span(events: Iterable, names: Optional[Iterable[str]] = None) -> Dict[str, object]:
    """Device time of a finished profiler's ``events`` (``prof.events()``)
    by program span, in ms over the whole stretch: ``device_ms`` (a kernel
    counted under the span open when the host op that launched it started;
    kernels that the profiler links to no host op under ``OUTSIDE``),
    ``idle_ms`` (the device's idle stretches between the first and the last
    event, by the span open at each one's middle), ``kernel_ms`` (every
    kernel's time) and ``busy_ms`` (their union). ``names``: the spans to
    read (default: every span this process has closed); other user
    annotations, such as a profiler's step marks, are passed over."""
    from torch.autograd import DeviceType

    names = set(_SPANS) if names is None else set(names)
    spans: List[Interval] = []
    launches: List[Tuple[float, float]] = []
    direct: Dict[str, float] = {}
    kernels: List[Tuple[float, float]] = []
    for e in events:
        a, z = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                kernels.append((a, z))
            continue
        if e.device_type != DeviceType.CPU or getattr(e, "is_async", False):
            continue
        linked = sum(float(k.duration) for k in e.kernels)
        if e.is_user_annotation:
            if e.name in names:
                spans.append((e.name, a, z))
                if linked:
                    # a kernel launched in the span itself, under no op
                    direct[e.name] = direct.get(e.name, 0.0) + linked
        elif linked:
            launches.append((a, linked))
    device = device_by_span(spans, launches)
    for name, us in direct.items():
        device[name] = device.get(name, 0.0) + us
    kernel_us = sum(z - a for a, z in kernels)
    linked_us = sum(device.values())
    if kernel_us > linked_us:
        device[OUTSIDE] = device.get(OUTSIDE, 0.0) + kernel_us - linked_us
    stamps = [t for _, a, z in spans for t in (a, z)] + [t for k in kernels for t in k]
    start, end = (min(stamps), max(stamps)) if kernels else (0.0, 0.0)
    idle = idle_by_span(spans, kernels, start, end)

    def ms(d):
        return {k: v / 1e3 for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    return {"device_ms": ms(device), "idle_ms": ms(idle), "kernel_ms": kernel_us / 1e3,
            "busy_ms": (end - start - sum(idle.values())) / 1e3}
