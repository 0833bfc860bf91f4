"""Task abstraction: manifest parsing + slice decoding + temp-label naming.

An own copy of ``aide_tpu.data.tasks.base``. A Task parses its manifest into
``SliceSpec`` rows, decodes one slice to uint8-range image(s) and a mask,
and names/reads/writes per-net refreshed working labels ("temp masks").
Pillow is imported only when an image must actually be resized.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


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


def resize_image(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) uint8-range image (PIL semantics:
    the values are cast to uint8 first). At the target size already, PIL
    returns a copy, and so does this, without importing PIL."""
    u8 = arr.astype(np.uint8)
    if u8.shape[:2] == (size, size):
        return u8.astype(np.float32)
    from PIL import Image

    img = Image.fromarray(u8).resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def resize_mask(mask: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour mask resize; ``size`` is an edge or an (H, W) pair.
    At the target size already, a uint8 copy without importing PIL."""
    h, w = (size, size) if isinstance(size, int) else size
    u8 = mask.astype(np.uint8)
    if u8.shape[:2] == (h, w):
        return u8.copy()
    from PIL import Image

    img = Image.fromarray(u8).resize((w, h), Image.NEAREST)
    return np.asarray(img, dtype=np.uint8)


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    return np.repeat(gray[..., None], 3, axis=-1)


class Task:
    """Base class; subclasses set ``name``/``two_modal`` and implement the
    manifest/decode/tempmask hooks."""

    name: str = ""
    two_modal: bool = False
    num_classes: int = 2
    tempmask_ext: str = "png"

    def __init__(self, root: str, tempmask_folder: str = "", mask_identity=None, **kw):
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

    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        raise NotImplementedError

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        raise NotImplementedError

    def _ensure_dir(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
