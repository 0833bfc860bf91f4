"""Mean ms of the train feed a step: the port's span ``train.data`` (the
next batch, its move to the card, the augment and view draws) over the
steps of the window's whole epochs (host clock)."""

from benchmark import spans


def read(record):
    return spans.per_step_ms(record, "train.data")
