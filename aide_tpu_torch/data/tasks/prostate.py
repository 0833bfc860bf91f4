"""Prostate ISBI task (single-modal NRRD or NIfTI volumes, cross-domain transfer).

An own copy of ``aide_tpu.data.tasks.prostate``, reading the manifest with
the csv module: ``Image,Mask,Depth`` columns addressing slices of 3D
volumes, per-slice max-normalization to [0, 255]
(datasetprostate_proposed/dataset.py:24-26), masks binarized at > 0 (:45),
and per-net working labels mirrored as whole-case volumes at the volume's
native resolution, ``<tempmask>/<maskbase>_netK.<ext>`` (:32-41).

Volumes are memoized per path: the reference re-reads the full volume for
every slice access.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.io import nifti, nrrd
from aide_tpu_torch.data.tasks.base import (
    SliceSpec,
    Task,
    gray_to_rgb,
    manifest_int,
    read_csv_rows,
    resize_mask,
)


def read_volume(path: str) -> np.ndarray:
    """(z, y, x) volume from NRRD or NIfTI by extension."""
    if path.endswith((".nrrd", ".nhdr")):
        return nrrd.read_nrrd(path)[0]
    return nifti.read_nifti(path)


def write_volume(path: str, volume: np.ndarray) -> None:
    if path.endswith((".nrrd", ".nhdr")):
        nrrd.write_nrrd(path, volume)
    else:
        nifti.write_nifti(path, volume)


@TASKS.register("prostate")
class ProstateTask(Task):
    name = "prostate"
    two_modal = False

    def __init__(self, root: str, tempmask_folder: str = "", **kw):
        super().__init__(root, tempmask_folder, **kw)
        self._cache: Dict[str, np.ndarray] = {}

    def _volume(self, rel_path: str) -> np.ndarray:
        if rel_path not in self._cache:
            self._cache[rel_path] = read_volume(os.path.join(self.root, rel_path))
        return self._cache[rel_path]

    # ---- manifest ----
    def load_manifest(self, csv_path: str, train: bool = True) -> List[SliceSpec]:
        specs = []
        for i, row in enumerate(read_csv_rows(csv_path)):
            img, depth = row["Image"], manifest_int(row["Depth"])
            specs.append(
                SliceSpec(
                    index=i,
                    case_id=os.path.basename(img).split(".")[0],
                    sort_key=f"{img}#{depth:04d}",
                    image_paths=(img,),
                    mask_path=row["Mask"],
                    depth=depth,
                    extras={"train": train},
                )
            )
        return specs

    # ---- decode ----
    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        vol = self._volume(spec.image_paths[0])
        sl = vol[spec.depth].astype(np.float32)
        mx = float(sl.max()) if float(sl.max()) > 0 else 1.0
        # float -> PIL 'F' -> 'L' truncates, hence floor (dataset.py:24-28)
        u8 = np.floor(np.clip(sl / mx * 255.0, 0, 255)).astype(np.uint8)
        mask = self._volume(spec.mask_path)[spec.depth]
        binary = (mask > 0).astype(np.uint8)
        return (gray_to_rgb(u8).astype(np.float32),), binary

    # ---- temp labels (whole-case volume files) ----
    def tempmask_path_case(self, mask_rel: str, net: int) -> str:
        base = os.path.basename(mask_rel).split(".")[0]
        ext = mask_rel.split(".")[-1]
        return os.path.join(self.root, self.tempmask_folder, f"{base}_net{net}.{ext}")

    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        return self.tempmask_path_case(spec.mask_path, net)

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        path = self.tempmask_path(spec, net)
        if not os.path.exists(path):
            return None
        key = f"temp:{path}"
        if key not in self._cache:
            self._cache[key] = read_volume(path)
        return (self._cache[key][spec.depth] > 0).astype(np.uint8)

    def write_case_predictions(
        self,
        out_dir: str,
        case_id: str,
        specs: Sequence[SliceSpec],
        volume: np.ndarray,
        png_scale: int = 63,
    ) -> None:
        """One whole-case volume file, ``<case>.nii.gz``, 0/255 with the
        slices at the specs' depths; depths not in the manifest are zero."""
        os.makedirs(out_dir, exist_ok=True)
        depth = max(spec.depth for spec in specs) + 1
        out = np.zeros((depth,) + volume.shape[1:], np.uint8)
        for spec, sl in zip(specs, volume):
            out[spec.depth] = sl
        write_volume(os.path.join(out_dir, f"{case_id}.nii.gz"), out * 255)

    def write_case_tempmask(self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int) -> None:
        # specs address depths of one mask volume: scatter the slices into a
        # full-size volume (unrefreshed depths keep the mask's labels).
        # Refreshed slices arrive at cfg.data.img_size and the mirror keeps
        # the NATIVE resolution, so resize first (LabelStore resizes back).
        mask_rel = specs[0].mask_path
        out = (self._volume(mask_rel) > 0).astype(np.uint8)
        for spec, sl in zip(specs, volume):
            if sl.shape != out.shape[1:]:
                sl = resize_mask(sl, out.shape[1:])
            out[spec.depth] = sl
        path = self.tempmask_path_case(mask_rel, net)
        self._ensure_dir(path)
        write_volume(path, out)
        self._cache.pop(f"temp:{path}", None)
