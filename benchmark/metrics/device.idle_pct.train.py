"""Idle share of the device in %, a train step: 100 * (1 - the profiled
steps' device-busy time a step / the window's mean step time). The busy
time is the union of kernel intervals, which the profiler does not
lengthen; the step time is the untraced window's, so the profiler's own
host cost stays out."""

from benchmark import manifest


def read(record):
    busy = manifest.reader("model.busy_ms")(record)
    step = manifest.reader("train.step_ms")(record)
    if busy is None or not step:
        return None
    return 100.0 * (1.0 - busy / step)
