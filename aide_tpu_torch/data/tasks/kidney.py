"""QUBIQ kidney task (noisy multi-annotator NIfTI masks, 2D per image).

An own copy of ``aide_tpu.data.tasks.kidney``, reading the manifest with
the csv module: ``Image,Mask1,Mask2,Mask3`` columns (one single-slice NIfTI
per image); training uses annotator ``mask_identity``'s mask, testing the
mean-of-three vote binarized at 0.5 (datasetkidney_comparison/
dataset.py:34-46); an ``Image``-only manifest gives unlabeled specs for
label-free inference; working labels are
``<tempmask>/<dir>/<base>_netK.nii.gz`` at 255
(datasetkidney_proposed/dataset.py:35-38). Refresh granularity is per
image: each slice is its own "case".
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.io import nifti
from aide_tpu_torch.data.tasks.base import SliceSpec, Task, gray_to_rgb, read_csv_rows


def _slice2d(path: str) -> np.ndarray:
    vol = nifti.read_nifti(path)
    return vol[0] if vol.ndim == 3 else vol


def _stem(path: str) -> str:
    return os.path.basename(path).split(".")[0]


@TASKS.register("kidney")
class KidneyTask(Task):
    name = "kidney"
    two_modal = False
    tempmask_ext = "nii.gz"

    def __init__(self, root: str, tempmask_folder: str = "", mask_identity: int = 1, **kw):
        super().__init__(root, tempmask_folder, **kw)
        self.mask_identity = int(mask_identity)

    # ---- manifest ----
    def load_manifest(self, csv_path: str, train: bool = True) -> List[SliceSpec]:
        rows = read_csv_rows(csv_path)
        if rows and "Mask1" not in rows[0]:
            # image-only manifest for label-free inference
            # (datasetkidney_comparison/dataset_testing.py:8-24)
            return [
                SliceSpec(
                    index=i,
                    case_id=_stem(row["Image"]),
                    sort_key=row["Image"],
                    image_paths=(row["Image"],),
                    mask_path="",
                    extras={"train": False, "unlabeled": True},
                )
                for i, row in enumerate(rows)
            ]
        specs = []
        for i, row in enumerate(rows):
            img = row["Image"]
            mask_cols = (row["Mask1"], row["Mask2"], row["Mask3"])
            specs.append(
                SliceSpec(
                    index=i,
                    case_id=_stem(img),
                    sort_key=img,
                    image_paths=(img,),
                    mask_path=mask_cols[self.mask_identity - 1],
                    extras={"train": train, "all_masks": mask_cols},
                )
            )
        return specs

    # ---- decode ----
    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        img = _slice2d(os.path.join(self.root, spec.image_paths[0])).astype(np.float32)
        mx = float(img.max()) if float(img.max()) > 0 else 1.0
        u8 = np.floor(np.clip(img / mx * 255.0, 0, 255)).astype(np.uint8)

        if spec.extras.get("unlabeled"):
            binary = np.zeros(u8.shape, np.uint8)
        elif spec.extras.get("train", True):
            mask = _slice2d(os.path.join(self.root, spec.mask_path))
            binary = (mask > 0.5).astype(np.uint8)
        else:
            # test: the mean of the three annotators, binarized
            acc = None
            for m in spec.extras["all_masks"]:
                arr = _slice2d(os.path.join(self.root, m)).astype(np.float32)
                acc = arr if acc is None else acc + arr
            binary = (acc / 3.0 > 0.5).astype(np.uint8)
        return (gray_to_rgb(u8).astype(np.float32),), binary

    # ---- temp labels ----
    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        parent = os.path.basename(os.path.dirname(spec.mask_path))
        return os.path.join(
            self.root, self.tempmask_folder, parent, f"{_stem(spec.mask_path)}_net{net}.nii.gz"
        )

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        path = self.tempmask_path(spec, net)
        if not os.path.exists(path):
            return None
        return (_slice2d(path) > 0.5).astype(np.uint8)

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        for spec, sl in zip(specs, volume):
            path = self.tempmask_path(spec, net)
            self._ensure_dir(path)
            nifti.write_nifti(path, sl[None].astype(np.uint8) * 255)

    def write_case_predictions(
        self,
        out_dir: str,
        case_id: str,
        specs: Sequence[SliceSpec],
        volume: np.ndarray,
        png_scale: int = 63,
    ) -> None:
        """One 0/255 .nii.gz per image under <out_dir>/<case>/, named after
        the image stem (the dataset's per-image mask convention)."""
        folder = os.path.join(out_dir, str(case_id))
        os.makedirs(folder, exist_ok=True)
        for spec, sl in zip(specs, volume):
            nifti.write_nifti(
                os.path.join(folder, f"{_stem(spec.image_paths[0])}.nii.gz"),
                sl[None].astype(np.uint8) * 255,
            )
