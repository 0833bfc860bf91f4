"""Seconds an epoch spends on the best-checkpoint gate and the label
refresh (``time_ckpt`` + ``time_refresh``), the mean over the window's
epochs."""


def read(record):
    rows = record.get("rows")
    if not rows:
        return None
    return sum(r["time_ckpt"] + r["time_refresh"] for r in rows) / len(rows)
