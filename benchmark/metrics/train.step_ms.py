"""Mean train step in ms: the epoch rows' ``time_train`` over the steps of
the window's whole epochs (host clock, data feed included)."""


def read(record):
    rows = record.get("rows")
    if not rows:
        return None
    return 1e3 * sum(r["time_train"] for r in rows) / (len(rows) * record["steps_per_epoch"])
