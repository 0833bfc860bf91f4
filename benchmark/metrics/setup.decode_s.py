"""Seconds of set-up spent decoding: the Trainer's manifests and both slice
pipelines, where the synthetic slices are made and decoded (the port's span
``setup.decode``, host clock), as the process's latest Trainer build read
it; the run builds one. None where the port has no such span."""


def read(record):
    try:
        from aide_tpu_torch.core import trace
    except ImportError:
        return None
    return trace.last("setup.decode")
