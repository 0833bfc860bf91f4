"""Grayscale PNG mask IO.

An own copy of ``aide_tpu.data.io.png``. Pillow is imported inside the
functions: only reading or writing a tempmask needs it, and a machine that
trains from generated or cached arrays may not have it.
"""

from __future__ import annotations

import numpy as np


def read_mask(path: str) -> np.ndarray:
    """Read a mask PNG as (H, W) uint8 intensity values."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.uint8)


def write_mask(path: str, mask: np.ndarray, scale: int = 63) -> None:
    """Write a binary/class-index mask as intensity * scale (zlib level 1:
    refreshes rewrite many near-constant masks per epoch)."""
    from PIL import Image

    arr = (np.asarray(mask) * scale).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(path, compress_level=1)

