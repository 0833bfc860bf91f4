"""Explicit random streams: one ``torch.Generator`` per purpose.

The counterpart of ``aide_tpu.core.prng``: where the JAX package folds one
root key per experiment into per-epoch and per-step keys, the port derives
a seed for each (experiment seed, epoch, step) with NumPy's ``SeedSequence``
and seeds a fresh generator from it. The two packages draw different
numbers from the same seed; tests hand both the same values instead.
"""

from __future__ import annotations

import numpy as np
import torch


def derive_seed(*parts: int) -> int:
    """A 63-bit seed mixed from non-negative integers (seed, epoch, step...)."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32
    )
    return (int(words[0]) << 31) ^ int(words[1])


def generator(device, *parts: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``derive_seed(*parts)``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(*parts))
    return g
