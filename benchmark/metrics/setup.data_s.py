"""Seconds to build the program over the data: the Trainer (synthetic data
generated, decoded, uploaded; nets built). Host clock."""


def read(record):
    return record["spans"].get("setup.data")
