"""Largest-connected-component post-processing (host side).

An own copy of ``aide_tpu.ops.cc.keep_largest_connected_components``: the
components of the foreground under face connectivity (4 neighbours in 2D,
6 in 3D on (S, H, W) volumes, skimage's ``connectivity=1``), of which only
the largest is kept. Where several components share the largest size, the
kept one is the component whose LAST voxel in raster order comes first:
the rule of the JAX package's native union-find (``native/hostops.cpp``,
which keeps the first component whose running count reaches the maximum).
The JAX package falls back to scipy's first-voxel rule when its native
library cannot be built; the port has one rule wherever it runs.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def keep_largest_connected_components(mask: np.ndarray) -> np.ndarray:
    """(H, W) or (S, H, W) mask -> uint8 mask of its largest foreground
    component (all zeros when the mask has no foreground)."""
    mask = np.asarray(mask)
    out = np.zeros(mask.shape, dtype=np.uint8)
    labels, num = ndimage.label(mask > 0)
    if num == 0:
        return out
    flat = labels.ravel()
    sizes = np.bincount(flat, minlength=num + 1)
    sizes[0] = 0  # background
    tied = np.flatnonzero(sizes == sizes.max())
    keep = tied[0]
    if len(tied) > 1:
        fg = np.flatnonzero(flat)
        last = np.zeros(num + 1, np.int64)
        np.maximum.at(last, flat[fg], fg)
        keep = tied[np.argmin(last[tied])]
    out[labels == keep] = 1
    return out
