"""The synthetic ellipse task's slices, made from a seed, and their
per-image normalisation: a frozen copy of the generator of
``aide_tpu_torch/data/tasks/synthetic.py`` (style ``ellipse``, binary) and
of the pipeline's per-image statistics, so both sides see the same inputs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def ellipse_slice(seed: int, case: int, sl: int, size: int, clean_cases: int,
                  noisy_fraction: float, noise_shift_divisor: int = 8):
    """(image, clean mask, noisy mask) of one slice: an ellipse 120 grey
    levels over a noisy background; from the ``clean_cases``-th case on, a
    share ``noisy_fraction`` of the train labels shifted by up to
    size / noise_shift_divisor px."""
    rng = np.random.default_rng((seed * 1000003 + case * 1009 + sl) % (2**31))
    s = size
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    cy = s * (0.35 + 0.3 * rng.random())
    cx = s * (0.35 + 0.3 * rng.random())
    ry = s * (0.10 + 0.15 * rng.random())
    rx = s * (0.10 + 0.15 * rng.random())
    mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(np.uint8)
    base = 60 + 40 * rng.random()
    img = base + 120.0 * mask + 20.0 * rng.normal(size=(s, s))
    img = np.clip(img, 0, 255).astype(np.float32)
    noisy = mask
    if case >= clean_cases and rng.random() < noisy_fraction:
        lim = max(1, s // noise_shift_divisor)
        dy, dx = rng.integers(-lim, lim, size=2)
        noisy = np.roll(np.roll(mask, dy, 0), dx, 1)
    return img, mask, noisy


def slice_index(data: Dict, case: int, sl: int) -> int:
    """Row of (case, slice) in the train manifest: cases in order, slices
    in order within each."""
    return case * data["slices_per_case"] + sl


def rows_to_slices(data: Dict, rows: Sequence[int], train: bool = True):
    """(case, slice) of each manifest row."""
    per = data["slices_per_case"]
    offset = 0 if train else data["test_case_offset"]
    return [(offset + int(r) // per, int(r) % per) for r in rows]


def normalise(u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 -> (the image standardised per channel by its own
    mean and N-1 std, the value a black pixel takes: the warp's fill)."""
    x = u8.astype(np.float32) / 255.0
    mean = x.mean(axis=(0, 1))
    std = np.maximum(x.std(axis=(0, 1), ddof=1), 1e-6)
    return (x - mean) / std, -mean / std


def batch(data: Dict, slices, train: bool, device) -> Dict[str, torch.Tensor]:
    """The normalised images, their fills and the labels (noisy on train
    slices, clean on test ones) of ``slices`` [(case, slice)], on
    ``device``: ``images`` a tuple of (B, H, W, 3) f32 (two with
    ``two_modal``: the image and its inverse 255 - image), ``fills`` a
    tuple of (B, 3), ``target`` (B, H, W) int64."""
    two = data["two_modal"]
    mods = [[] for _ in range(2 if two else 1)]
    fills = [[] for _ in mods]
    targets = []
    for case, sl in slices:
        img, mask, noisy = ellipse_slice(data["seed"], case, sl, data["img_size"],
                                         data["clean_cases"], data["noisy_fraction"])
        grays = [img.astype(np.uint8)]
        if two:
            grays.append((255 - img).astype(np.uint8))
        for m, g in enumerate(grays):
            x, f = normalise(np.repeat(g[..., None], 3, axis=-1))
            mods[m].append(x)
            fills[m].append(f)
        targets.append(noisy if train else mask)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.stack(a)).to(device=device, dtype=dtype)

    return {"images": tuple(dev(m) for m in mods), "fills": tuple(dev(f) for f in fills),
            "target": dev(targets, torch.int64)}
