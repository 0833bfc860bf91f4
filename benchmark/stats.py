"""The window's rules and the statistics of its end-to-end metrics."""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, List, Sequence


def whole_epochs(run_epoch: Callable[[int], object], first: int, seconds: float,
                 clock: Callable[[], float] = time.perf_counter) -> List[float]:
    """Run epochs ``first``, ``first + 1``, ... and return each one's
    seconds. The first always runs; a later one starts only if it would end
    within ``seconds`` of the window's start by the longest epoch so far,
    so no epoch is cut and none is counted in part."""
    times: List[float] = []
    start = clock()
    epoch = first
    while not times or clock() - start + max(times) <= seconds:
        t0 = clock()
        run_epoch(epoch)
        times.append(clock() - t0)
        epoch += 1
    return times


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
