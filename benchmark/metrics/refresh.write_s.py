"""Seconds an epoch spends writing the refreshed cases' tempmask files:
the port's span ``refresh.write``, the mean over the window's whole
epochs."""

from benchmark import spans


def read(record):
    return spans.per_epoch_s(record, "refresh.write")
