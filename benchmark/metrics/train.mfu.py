"""Model FLOP utilisation in %: FlopCounterMode's count of one real step
(outside the window) over the window's mean real step time
(``time_train`` over its steps) and the card's dense bf16 peak. None on
a card without a listed peak."""

from benchmark import peaks


def read(record):
    rows, flops = record.get("rows"), record.get("flops")
    peak = peaks.BF16_TFLOPS.get(record["device"]["name"])
    if not rows or not flops or not peak:
        return None
    step_s = sum(r["time_train"] for r in rows) / (len(rows) * record["steps_per_epoch"])
    return 100.0 * flops / step_s / (peak * 1e12)
