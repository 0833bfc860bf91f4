"""Share of the window's train steps that replayed a CUDA graph, in %: the
port's counter ``train.graph_replays`` over its ``train.step`` spans, in
the window's whole epochs (``benchmark.spans.window``). None where the
port counts no graph steps (a program from before them) or the window
holds no step."""

from benchmark import spans

COUNTERS = ("train.graph_replays", "train.graph_captures", "train.graph_eager")


def read(record):
    spent = spans.window(record)
    if spent is None:
        return None
    steps = spent.get("train.step", (0.0, 0))[1]
    if not steps or not any(name in spent for name in COUNTERS):
        return None
    return 100.0 * spent.get("train.graph_replays", 0) / steps
