"""Breast MR task (NIfTI volumes; clean 'segmentation' masks and per-slice
noisy PNG labels).

An own copy of ``aide_tpu.data.tasks.breast``, reading the manifest with
the csv module: ``Image,Mask,Depth``; ground-truth masks are NIfTI volumes
whose filename contains 'segmentation' (datasetbreast_proposed/
dataset.py:35-39), noisy labels live in per-case folders of
``<case>_depth<d>.png`` slices (:54); working labels are
``<tempmask>/<case>/<case>_depth<d>_netK.png`` at 255 (:42-45).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.io import nifti, png
from aide_tpu_torch.data.tasks.base import (
    SliceSpec,
    Task,
    gray_to_rgb,
    manifest_int,
    read_csv_rows,
)


@TASKS.register("breast")
class BreastTask(Task):
    name = "breast"
    two_modal = False

    def __init__(self, root: str, tempmask_folder: str = "", **kw):
        super().__init__(root, tempmask_folder, **kw)
        self._cache: Dict[str, np.ndarray] = {}

    def _volume(self, rel: str) -> np.ndarray:
        if rel not in self._cache:
            self._cache[rel] = nifti.read_nifti(os.path.join(self.root, rel))
        return self._cache[rel]

    @staticmethod
    def _case_of(mask_rel: str) -> str:
        name = os.path.basename(mask_rel)
        if "segmentation" in name:
            return name.split("_")[0]
        return name

    # ---- manifest ----
    def load_manifest(self, csv_path: str, train: bool = True) -> List[SliceSpec]:
        specs = []
        for i, row in enumerate(read_csv_rows(csv_path)):
            img, mask, depth = row["Image"], row["Mask"], manifest_int(row["Depth"])
            specs.append(
                SliceSpec(
                    index=i,
                    case_id=self._case_of(mask),
                    sort_key=f"{img}#{depth:04d}",
                    image_paths=(img,),
                    mask_path=mask,
                    depth=depth,
                    extras={"train": train, "gt": "segmentation" in os.path.basename(mask)},
                )
            )
        return specs

    # ---- decode ----
    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        vol = self._volume(spec.image_paths[0])
        sl = vol[spec.depth].astype(np.float32)
        mx = float(sl.max()) if float(sl.max()) > 0 else 1.0
        u8 = np.floor(np.clip(sl / mx * 255.0, 0, 255)).astype(np.uint8)

        if spec.extras.get("gt") or not spec.extras.get("train", True):
            mask = self._volume(spec.mask_path)[spec.depth]
        else:
            case = spec.case_id
            mask = png.read_mask(os.path.join(self.root, spec.mask_path, f"{case}_depth{spec.depth}.png"))
        binary = (np.asarray(mask) > 0).astype(np.uint8)
        return (gray_to_rgb(u8).astype(np.float32),), binary

    # ---- temp labels ----
    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        case = spec.case_id
        return os.path.join(
            self.root, self.tempmask_folder, case, f"{case}_depth{spec.depth}_net{net}.png"
        )

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        path = self.tempmask_path(spec, net)
        if not os.path.exists(path):
            return None
        return (png.read_mask(path) > 0).astype(np.uint8)

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        for spec, sl in zip(specs, volume):
            path = self.tempmask_path(spec, net)
            self._ensure_dir(path)
            png.write_mask(path, sl, scale=255)
