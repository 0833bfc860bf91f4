"""Milliseconds the refresh spends writing one image's working labels: the
port's span ``refresh.write`` over its counter ``refresh.images`` (the
images a refresh rewrote, both nets), in the window's whole epochs. None
where the port counts no rewritten image (a program from before the
counter, or a window whose refreshes rewrote none)."""

from benchmark import spans


def read(record):
    spent = spans.window(record)
    if spent is None or not spent.get("refresh.images"):
        return None
    return 1e3 * spent.get("refresh.write", (0.0, 0))[0] / spent["refresh.images"]
