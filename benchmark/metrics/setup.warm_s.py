"""Seconds of the warm-up epoch before the window. Host clock."""


def read(record):
    return record["spans"].get("setup.warm")
