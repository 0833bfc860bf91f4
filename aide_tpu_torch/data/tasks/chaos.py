"""CHAOS T1-DUAL liver task (two-modal in-phase/out-phase DICOM).

An own copy of ``aide_tpu.data.tasks.chaos``, reading the manifest with the
csv module: ``Inphase,Outphase,Mask`` columns, DICOM slice pairs, grayscale
PNG masks with the class palette [0, 63, 126, 189, 252] (liver = 63), and
per-net refreshed working labels stored as
``<tempmask>/<case>/<img>_netK.png`` with foreground encoded as 63
(trainchaos_proposed_30cases1labeled.py:543-575).

The reference converts uint16 DICOM pixel arrays to 8-bit via PIL, which
SATURATES values above 255 (datasetchaos_proposed/dataset.py:24-32). The
default ``window='clip255'`` replicates that; ``window='max'`` instead
scales by the per-slice max.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.io import dicom, png
from aide_tpu_torch.data.tasks.base import (
    SliceSpec,
    Task,
    gray_to_rgb,
    read_csv_rows,
    to_uint8_saturate,
)

FOREGROUND_VALUE = 63  # liver class intensity in CHAOS ground-truth PNGs
PALETTE = [0, 63, 126, 189, 252]


@TASKS.register("chaos")
class ChaosTask(Task):
    name = "chaos"
    two_modal = True

    def __init__(self, root: str, tempmask_folder: str = "", window: str = "clip255", **kw):
        super().__init__(root, tempmask_folder, **kw)
        self.window = window

    def decode_fingerprint(self) -> str:
        return f"ChaosTask:window={self.window}"

    # ---- manifest ----
    def load_manifest(self, csv_path: str, train: bool = True) -> List[SliceSpec]:
        specs = []
        for i, row in enumerate(read_csv_rows(csv_path)):
            inphase, outphase, mask = row["Inphase"], row["Outphase"], row["Mask"]
            specs.append(
                SliceSpec(
                    index=i,
                    case_id=self._case_of(inphase),
                    sort_key=inphase,
                    image_paths=(inphase, outphase),
                    mask_path=mask,
                    extras={"train": train},
                )
            )
        validate_phase_alignment(specs)
        return specs

    @staticmethod
    def _case_of(path: str) -> str:
        """Case id from the path (dataset.py:33-35)."""
        parts = path.split("/")
        return parts[2] if len(parts) > 2 and parts[2].isdigit() else parts[0]

    # ---- decode ----
    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        imgs = []
        for p in spec.image_paths:
            arr = dicom.read_dicom(os.path.join(self.root, p)).pixel_array
            if self.window == "clip255":
                u8 = to_uint8_saturate(arr)
            else:
                mx = float(arr.max()) or 1.0
                u8 = (arr.astype(np.float32) / mx * 255.0).astype(np.uint8)
            imgs.append(gray_to_rgb(u8).astype(np.float32))
        mask = png.read_mask(os.path.join(self.root, spec.mask_path))
        binary = (mask == FOREGROUND_VALUE).astype(np.uint8)
        return tuple(imgs), binary

    # ---- temp labels ----
    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        base = os.path.basename(spec.mask_path).split(".")[0]
        return os.path.join(self.root, self.tempmask_folder, spec.case_id, f"{base}_net{net}.png")

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        path = self.tempmask_path(spec, net)
        if not os.path.exists(path):
            return None
        return (png.read_mask(path) == FOREGROUND_VALUE).astype(np.uint8)

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        for spec, sl in zip(specs, volume):
            path = self.tempmask_path(spec, net)
            self._ensure_dir(path)
            png.write_mask(path, sl, scale=FOREGROUND_VALUE)


def validate_phase_alignment(specs: Sequence[SliceSpec]) -> None:
    """The reference asserts in/out-phase/mask filename correspondence in its
    eval loops (trainchaos_proposed_30cases1labeled.py:390-395); here it is
    validated once at manifest load: same basename stem for inphase/mask and
    inphase instance number == outphase instance number + 1."""
    for s in specs:
        inphase, outphase = s.image_paths
        in_base = os.path.basename(inphase).split(".")[0]
        mask_base = os.path.basename(s.mask_path).split(".")[0]
        if in_base != mask_base:
            raise ValueError(f"mask/in-phase mismatch: {inphase} vs {s.mask_path}")
        try:
            in_no = int(in_base.split("-")[-1])
            out_no = int(os.path.basename(outphase).split(".")[0].split("-")[-1])
        except ValueError:
            continue
        if in_no != out_no + 1:
            raise ValueError(f"in/out-phase instance misalignment: {inphase} vs {outphase}")
