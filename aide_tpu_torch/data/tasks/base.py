"""Task abstraction: manifest parsing + slice decoding + temp-label naming.

An own copy of ``aide_tpu.data.tasks.base``. A Task parses its manifest into
``SliceSpec`` rows, decodes one slice to uint8-range image(s) and a mask,
and names/reads/writes per-net refreshed working labels ("temp masks").

The resizes are Pillow's, in numpy: ``resize_image`` is Pillow's 8-bit
BILINEAR resample and ``resize_mask`` its NEAREST resize, equal to Pillow's
uint8 output bit for bit (tests/test_torch_io.py holds them to it), so a
machine without Pillow decodes the same pixels.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Pillow's fixed-point resample: 22 fraction bits for an 8-bit image
_PRECISION_BITS = 32 - 8 - 2


@dataclass
class SliceSpec:
    """One training/eval slice."""

    index: int                      # position in the manifest
    case_id: str                    # grouping key for 3D eval / refresh
    sort_key: str                   # within-case ordering
    image_paths: Tuple[str, ...]    # 1 (single-modal) or 2 (two-modal) paths
    mask_path: str
    depth: int = 0
    extras: Dict[str, object] = field(default_factory=dict)


def _bilinear_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(index, weight), each (out, K): the source pixels and fixed-point
    weights of Pillow's BILINEAR resample along one axis
    (libImaging/Resample.c ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): the triangle filter, its support widened by
    in/out when downscaling, taps over [int(center - support + 0.5),
    int(center + support + 0.5)) clipped to the axis, weights normalised to
    sum 1 in double, then rounded half away from zero to 22 fraction bits.
    The arithmetic runs in Python floats, which are the C code's doubles.
    Rows with fewer than K taps are padded with weight 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    k = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, k), np.int64)
    weight = np.zeros((out_size, k), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps, ww = [], 0.0
        for x in range(xmin, xmax):
            t = abs((x - center + 0.5) * ss)
            w = 1.0 - t if t < 1.0 else 0.0
            taps.append(w)
            ww += w
        for i, w in enumerate(taps):
            if ww != 0.0:
                w /= ww
            index[xx, i] = xmin + i
            weight[xx, i] = int(0.5 + w * (1 << _PRECISION_BITS))
    return index, weight


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resample along ``axis``: the taps' sum in
    integers from the rounding offset 1 << 21, shifted right by 22 and
    clipped to [0, 255]."""
    index, weight = _bilinear_taps(img.shape[axis], out_size)
    moved = np.moveaxis(img, axis, -1).astype(np.int64)
    acc = (moved[..., index] * weight).sum(axis=-1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_image(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8-range image to (size, size),
    as Pillow's ``Image.resize(..., BILINEAR)`` does it (the values are cast
    to uint8 first): a horizontal pass, then a vertical one, each rounding
    to uint8, each skipped where that edge already has its size."""
    u8 = arr.astype(np.uint8)
    if u8.shape[1] != size:
        u8 = _resample_axis(u8, size, axis=1)
    if u8.shape[0] != size:
        u8 = _resample_axis(u8, size, axis=0)
    return u8.astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output pixel of Pillow's NEAREST resize, a
    scale-only affine (libImaging/Geometry.c ``ImagingScaleAffine``): the
    coordinate starts at a/2 and grows by repeated addition of a = in/out
    in double, then truncates. At ratios that a double does not hold (497 ->
    512) that is not always floor((x + 0.5) * in / out). -1 marks a source
    outside the image, which Pillow fills with 0."""
    a = in_size / out_size
    xo = a * 0.5
    idx = np.empty(out_size, np.int64)
    for x in range(out_size):
        xin = -1 if xo < 0.0 else int(xo)
        idx[x] = xin if xin < in_size else -1
        xo += a
    return idx


def resize_mask(mask: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour mask resize as Pillow's ``Image.resize(...,
    NEAREST)``; ``size`` is an edge or an (H, W) pair."""
    h, w = (size, size) if isinstance(size, int) else size
    u8 = mask.astype(np.uint8)
    if u8.shape[:2] == (h, w):
        return u8.copy()
    rows, cols = _nearest_index(u8.shape[0], h), _nearest_index(u8.shape[1], w)
    out = u8[np.ix_(np.maximum(rows, 0), np.maximum(cols, 0))]
    out[rows < 0] = 0
    out[:, cols < 0] = 0
    return out


def to_uint8_saturate(arr: np.ndarray) -> np.ndarray:
    """Clip to [0, 255]: Pillow's 16-bit to 8-bit conversion, which the
    reference's CHAOS loader applies to DICOM pixels (every value above 255
    saturates)."""
    return np.clip(arr, 0, 255).astype(np.uint8)


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, axis=-1)


def read_csv_rows(csv_path: str) -> List[Dict[str, str]]:
    """A manifest's rows as dicts of strings (the JAX tasks read them with
    pandas; a row's position is pandas' ``iterrows`` index)."""
    with open(csv_path, newline="") as fh:
        return list(csv.DictReader(fh))


def manifest_int(value: str) -> int:
    """An integer cell of a manifest, as ``int()`` takes pandas' value of a
    numeric column ("3", "03" and "3.0" are 3)."""
    try:
        return int(value)
    except ValueError:
        return int(float(value))


class Task:
    """Base class; subclasses set ``name``/``two_modal`` and implement the
    manifest/decode/tempmask hooks."""

    name: str = ""
    two_modal: bool = False
    num_classes: int = 2
    tempmask_ext: str = "png"

    def __init__(self, root: str, tempmask_folder: str = "", mask_identity=None, **kw):
        # mask_identity is config-level (build_task passes it to every task);
        # only KidneyTask reads it. Anything else is a typo'd task option.
        if kw:
            raise TypeError(f"{type(self).__name__}: unknown task options {sorted(kw)}")
        self.root = root
        self.tempmask_folder = tempmask_folder

    def load_manifest(self, csv_path: str, train: bool = True) -> List[SliceSpec]:
        raise NotImplementedError

    @staticmethod
    def load_case_list(csv_path: str) -> List[str]:
        """The ``patient_case`` column of a case-level CSV, as strings. A
        column of numbers reads as pandas reads it: all integers as ints
        ("07" -> "7"), else all floats as floats, else the text as it is."""
        with open(csv_path, newline="") as fh:
            rows = csv.DictReader(fh)
            if rows.fieldnames is None or "patient_case" not in rows.fieldnames:
                raise KeyError(f"{csv_path!r} has no 'patient_case' column")
            values = [row["patient_case"] for row in rows]
        for cast in (int, float):
            try:
                return [str(cast(v)) for v in values]
            except ValueError:
                pass
        return values

    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        """Returns (images, mask): images float32 (H, W, 3) in [0, 255];
        mask (H, W) uint8."""
        raise NotImplementedError

    def decode_fingerprint(self) -> str:
        """Every task-level parameter that changes ``decode()`` for the same
        specs; part of SlicePipeline's decode-cache key (tasks with such
        knobs override)."""
        return type(self).__name__

    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        raise NotImplementedError

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        raise NotImplementedError

    def write_case_predictions(
        self,
        out_dir: str,
        case_id: str,
        specs: Sequence[SliceSpec],
        volume: np.ndarray,
        png_scale: int = 63,
    ) -> None:
        """Write a predicted (S, H, W) binary case volume under ``out_dir``
        in the task's native mask convention. Default: one PNG a slice, named
        after the source image's stem, under <out_dir>/<case>/. Tasks whose
        masks live in another format (kidney, prostate) override."""
        from aide_tpu_torch.data.io import png

        folder = os.path.join(out_dir, str(case_id))
        os.makedirs(folder, exist_ok=True)
        for spec, sl in zip(specs, volume):
            stem = os.path.basename(spec.image_paths[0]).split(".")[0]
            png.write_mask(os.path.join(folder, f"{stem}.png"), sl, scale=png_scale)

    def _ensure_dir(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
