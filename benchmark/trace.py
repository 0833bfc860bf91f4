"""Device time from a ``torch.profiler`` trace.

Kernels and host ops come out of the profiler as (name, start_us, end_us)
intervals. The device is busy in the union of the kernels' intervals (a
copy of ``chip_smoke.py``'s ``device_breakdown``); an idle gap is a stretch
of the traced window between kernels, labelled by the innermost host op
open at its middle.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, float, float]
OUTSIDE = "host code outside torch ops"


def from_profiler(prof) -> Tuple[List[Interval], List[Interval]]:
    """(kernels, host ops) of a finished profiler, in microseconds."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            kernels.append(iv)
        elif e.device_type == DeviceType.CPU:
            host.append(iv)
    return kernels, host


def busy_us(kernels: Sequence[Interval]) -> float:
    """Microseconds in which at least one kernel ran."""
    busy, end = 0.0, float("-inf")
    for _, a, z in sorted(kernels, key=lambda k: k[1]):
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    return busy


def kernel_us(kernels: Sequence[Interval], fragment: str) -> Tuple[float, int]:
    """Summed microseconds and count of the kernels whose name holds
    ``fragment``."""
    sel = [z - a for name, a, z in kernels if fragment in name]
    return sum(sel), len(sel)


def top_ops(kernels: Sequence[Interval], n: int = 10) -> List[List]:
    """The ``n`` kernel names with the most device time: [name, seconds]."""
    by_name: Dict[str, float] = {}
    for name, a, z in kernels:
        by_name[name] = by_name.get(name, 0.0) + (z - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]


def idle_gaps(kernels: Sequence[Interval], host: Sequence[Interval], start: float, end: float,
              n: int = 10) -> List[List]:
    """Idle device time in [start, end] summed by the innermost host op
    open at each gap's middle (``OUTSIDE`` where none is): the ``n``
    largest, as [name, seconds]."""
    spans = sorted((a, z) for _, a, z in kernels if z > start and a < end)
    gaps, at = [], start
    for a, z in spans:
        if a > at:
            gaps.append((at, a))
        at = max(at, z)
    if end > at:
        gaps.append((at, end))
    ops = sorted(host, key=lambda h: h[1])
    by_name: Dict[str, float] = {}
    active: List[Interval] = []
    i = 0
    for a, z in gaps:  # in time order: one sweep over the host ops
        mid = 0.5 * (a + z)
        while i < len(ops) and ops[i][1] <= mid:
            active.append(ops[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        name = max(active, key=lambda h: h[1])[0] if active else OUTSIDE
        by_name[name] = by_name.get(name, 0.0) + (z - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], us / 1e6] for name, us in top]
