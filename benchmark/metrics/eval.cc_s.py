"""Seconds an epoch spends on the largest connected component of each
evaluated case on the host: the port's span ``cases.cc``, the mean over
the window's whole epochs."""

from benchmark import spans


def read(record):
    return spans.per_epoch_s(record, "cases.cc")
