"""Largest-connected-component post-processing (host side).

An own copy of ``aide_tpu.ops.cc.keep_largest_connected_components``: the
components of the foreground under face connectivity (4 neighbours in 2D,
6 in 3D on (S, H, W) volumes, skimage's ``connectivity=1``), of which only
the largest is kept. ``keep_largest_connected_components`` runs the port's
native union-find (``aide_tpu_torch/native``, built from
``csrc/hostops.cpp``), as the JAX package runs its own; it raises where
that library cannot be built, with no fallback. Where several components
share the largest size, the kept one is the component whose LAST voxel in
raster order comes first: the union-find keeps the first component whose
running count reaches the maximum. ``keep_largest_connected_components_plain``
is the same function in numpy over ``scipy.ndimage.label``, with the same
tie rule, for the tests; nothing on the main path calls it.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from aide_tpu_torch import native


def keep_largest_connected_components(mask: np.ndarray) -> np.ndarray:
    """(H, W) or (S, H, W) mask -> uint8 mask of its largest foreground
    component (all zeros when the mask has no foreground), by the native
    union-find."""
    return native.keep_largest_cc(mask)


def keep_largest_connected_components_plain(mask: np.ndarray) -> np.ndarray:
    """``keep_largest_connected_components`` in numpy over scipy's labels,
    the same tie rule; any number of dimensions."""
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
