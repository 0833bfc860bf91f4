"""Seconds an epoch spends in the test pass and case evaluation
(``time_test`` + ``time_cases``), the mean over the window's epochs."""


def read(record):
    rows = record.get("rows")
    if not rows:
        return None
    return sum(r["time_test"] + r["time_cases"] for r in rows) / len(rows)
