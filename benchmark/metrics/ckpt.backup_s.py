"""Seconds an epoch spends copying the tempmask folder at a best epoch: the
port's span ``ckpt.backup`` (none in an epoch that was not best), the
mean over the window's whole epochs."""

from benchmark import spans


def read(record):
    return spans.per_epoch_s(record, "ckpt.backup")
