"""Fixture trees of the paper's four datasets, in their native formats.

``write_fixture_tree(cfg, ...)`` writes, from a numpy seed, a small dataset
at the paths that a preset's config names (``cli.presets.get_preset(name,
data_root)``): its manifests and case lists, and the image and mask files
they list, as the real data stores them:

- ``chaos``: explicit-VR little-endian 16-bit DICOM in-phase/out-phase
  pairs (values past 255, which the task's ``clip255`` window saturates) and
  palette PNG masks whose liver class is gray 63;
- ``prostate``: whole-case NRRD volumes and masks, one manifest row a slice;
- ``kidney``: single-slice NIfTI images with three annotators' masks;
- ``breast``: NIfTI volumes, a ``segmentation`` NIfTI mask for the labeled
  and the test cases, and folders of ``<case>_depth<d>.png`` noisy labels
  for the others.

Each slice holds a bright ellipse (the organ) over noise; the masks mark it,
the noisy labels shifted by a few pixels. So ``Trainer(get_preset(name,
root))`` trains from native files where the real data is absent.

``write_reference_chaos(ref_dir, ...)`` writes the part of the reference
repository's CHAOS tree that the real-data programs
(``aide_tpu_torch.experiments.chaos_real_*``) read, in its own layout.
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

from aide_tpu_torch.data.io import nifti, nrrd, png


def _organ(rng: np.random.Generator, slices: int, h: int, w: int) -> np.ndarray:
    """(slices, h, w) bool: an ellipse whose centre drifts across slices."""
    cy, cx = rng.uniform(0.35, 0.65, 2) * (h, w)
    ry, rx = rng.uniform(0.12, 0.25, 2) * (h, w)
    dy, dx = rng.uniform(-0.01, 0.01, 2) * (h, w)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([
        ((yy - cy - s * dy) / ry) ** 2 + ((xx - cx - s * dx) / rx) ** 2 <= 1.0 for s in range(slices)
    ])


def _image(rng: np.random.Generator, organ: np.ndarray, base: float, gain: float) -> np.ndarray:
    noise = rng.normal(base, base / 4, organ.shape)
    return np.clip(noise + gain * organ, 0, None).astype(np.int16)


def _shifted(rng: np.random.Generator, mask: np.ndarray) -> np.ndarray:
    """A noisy annotation: the mask rolled by up to 1/16 of its size."""
    lim = max(1, mask.shape[-1] // 16)
    dy, dx = rng.integers(-lim, lim + 1, 2)
    return np.roll(np.roll(mask, dy, -2), dx, -1)


def _path(root: str, rel: str) -> str:
    """``root/rel``, its directory made."""
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _write_csv(path: str, header: Sequence[str], rows: List[Sequence],
               lineterminator: str = "\r\n") -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh, lineterminator=lineterminator)
        out.writerow(header)
        out.writerows(rows)


def _case_lists(cfg, train: List[str], test: List[str], labeled: int) -> None:
    d = cfg.data
    _write_csv(d.traincase_csv, ["patient_case"], [[c] for c in train])
    _write_csv(d.testcase_csv, ["patient_case"], [[c] for c in test])
    _write_csv(d.labelcase_csv, ["patient_case"], [[c] for c in train[:labeled]])


def _dicom_element(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr in (b"UI", b"OB") else b" "
    head = struct.pack("<HH", group, elem) + vr
    if vr in (b"OB", b"OW", b"UN", b"SQ", b"UT"):
        return head + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + struct.pack("<H", len(value)) + value


def write_dicom(path: str, pixels: np.ndarray) -> None:
    """A part-10 explicit-VR little-endian DICOM of one unsigned 16-bit
    slice (Rows, Columns, the pixel format tags, PixelSpacing)."""
    rows, cols = pixels.shape

    def us(v: int) -> bytes:
        return struct.pack("<H", v)

    body = b"".join([
        _dicom_element(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1"),
        _dicom_element(0x0028, 0x0002, b"US", us(1)),
        _dicom_element(0x0028, 0x0010, b"US", us(rows)),
        _dicom_element(0x0028, 0x0011, b"US", us(cols)),
        _dicom_element(0x0028, 0x0030, b"DS", b"1.5\\1.5"),
        _dicom_element(0x0028, 0x0100, b"US", us(16)),
        _dicom_element(0x0028, 0x0101, b"US", us(16)),
        _dicom_element(0x0028, 0x0103, b"US", us(0)),
        _dicom_element(0x7FE0, 0x0010, b"OW", pixels.astype("<u2").tobytes()),
    ])
    with open(path, "wb") as fh:
        fh.write(b"\x00" * 128 + b"DICM" + body)


def write_palette_png(path: str, index: np.ndarray, grays: Sequence[int]) -> None:
    """An 8-bit palette PNG of class indices whose palette holds ``grays``."""
    h, w = index.shape
    palette = np.repeat(np.asarray(grays, np.uint8)[:, None], 3, axis=1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), index.astype(np.uint8)], axis=1)
    blob = (
        png._SIGNATURE
        + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
        + png._chunk(b"PLTE", palette.tobytes())
        + png._chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
        + png._chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(blob)


def _chaos(cfg, rng, train, test, slices, size) -> None:
    from aide_tpu_torch.data.tasks.chaos import PALETTE

    root = cfg.data.root
    for csv_path, cases in ((cfg.data.train_csv, train), (cfg.data.test_csv, test)):
        rows = []
        for case in cases:
            c = int(case)
            organ = _organ(rng, slices, size, size)
            # a second class (gray 126) in one quadrant, outside the liver
            second = np.zeros_like(organ)
            second[:, size // 2:, : size // 2] = _organ(rng, slices, size // 2, size // 2)
            second &= ~organ
            series = f"Train_Sets/MR/{c}/T1DUAL"
            for s in range(slices):
                # the in-phase instance follows its out-phase one, as CHAOS numbers them
                inphase = f"{series}/DICOM_anon/InPhase/IMG-{c:04d}-{2 * s + 2:05d}.dcm"
                outphase = f"{series}/DICOM_anon/OutPhase/IMG-{c:04d}-{2 * s + 1:05d}.dcm"
                mask = f"{series}/Ground/IMG-{c:04d}-{2 * s + 2:05d}.png"
                for rel, gain in ((inphase, 420.0), (outphase, 300.0)):
                    write_dicom(_path(root, rel), _image(rng, organ[s] | second[s], 120.0, gain))
                index = organ[s] * 1 + second[s] * 2
                write_palette_png(_path(root, mask), index, PALETTE)
                rows.append((inphase, outphase, mask))
        _write_csv(csv_path, ["Inphase", "Outphase", "Mask"], rows)


def _volumes(cfg, rng, train, test, slices, size, labeled, writer, ext) -> None:
    """Prostate (``writer`` nrrd) and breast (nifti) trees."""
    root = cfg.data.root
    breast = cfg.data.task == "breast"
    for csv_path, cases, is_train in ((cfg.data.train_csv, train, True), (cfg.data.test_csv, test, False)):
        rows = []
        for k, case in enumerate(cases):
            organ = _organ(rng, slices, size, size)
            image = f"images/{case}.{ext}"
            writer(_path(root, image), _image(rng, organ, 200.0, 700.0))
            noisy = is_train and k >= labeled
            if breast and noisy:
                mask = f"noisylabels/{case}"
                for s in range(slices):
                    png.write_mask(_path(root, f"{mask}/{case}_depth{s}.png"),
                                   _shifted(rng, organ[s]), scale=255)
            else:
                mask = f"masks/{case}_segmentation.{ext}"
                labels = _shifted(rng, organ) if noisy else organ
                writer(_path(root, mask), labels.astype(np.uint8))
            rows += [(image, mask, s) for s in range(slices)]
        _write_csv(csv_path, ["Image", "Mask", "Depth"], rows)


def _kidney(cfg, rng, train, test, size) -> None:
    root = cfg.data.root
    for csv_path, cases in ((cfg.data.train_csv, train), (cfg.data.test_csv, test)):
        rows = []
        for case in cases:
            organ = _organ(rng, 1, size, size)
            image = f"kidney/images/{case}.nii.gz"
            nifti.write_nifti(_path(root, image), _image(rng, organ, 200.0, 700.0))
            masks = []
            for a in (1, 2, 3):
                masks.append(f"kidney/masks/{case}_seg{a}.nii.gz")
                nifti.write_nifti(_path(root, masks[-1]), _shifted(rng, organ).astype(np.uint8))
            rows.append((image, *masks))
        _write_csv(csv_path, ["Image", "Mask1", "Mask2", "Mask3"], rows)


def write_fixture_tree(
    cfg, train_cases: int = 4, test_cases: int = 1, slices: int = 16, size: int = 256,
    labeled: int = 1, seed: int = 0,
) -> None:
    """Write the fixture dataset of ``cfg.data.task`` at the paths ``cfg``
    names: ``train_cases`` train and ``test_cases`` test cases of ``slices``
    slices (kidney: one image a case) at ``size`` x ``size`` px, the first
    ``labeled`` train cases listed in ``labelcase_csv`` (and, for breast,
    given a ``segmentation`` mask, the others noisy labels)."""
    rng = np.random.default_rng(seed)
    task = cfg.data.task
    if task == "chaos":
        train = [str(c + 1) for c in range(train_cases)]
        test = [str(c + 101) for c in range(test_cases)]
        _chaos(cfg, rng, train, test, slices, size)
    elif task in ("prostate", "breast"):
        train = [f"case{c:03d}" for c in range(train_cases)]
        test = [f"case{c + 100:03d}" for c in range(test_cases)]
        if task == "prostate":
            _volumes(cfg, rng, train, test, slices, size, labeled, nrrd.write_nrrd, "nrrd")
        else:
            _volumes(cfg, rng, train, test, slices, size, labeled, nifti.write_nifti, "nii.gz")
    elif task == "kidney":
        train = [f"case{c:03d}" for c in range(train_cases)]
        test = [f"case{c + 100:03d}" for c in range(test_cases)]
        _kidney(cfg, rng, train, test, size)
    else:
        raise ValueError(f"no fixture tree for task {task!r}")
    _case_lists(cfg, train, test, labeled)


# the reference tree's two cases that ship images, and their slice pairs
REFERENCE_CASES = (("37", 30), ("10", 50))
# the folder of the 1-case pretrain's bootstrap pseudo-labels, under All_Sets
REFERENCE_PSEUDO_DIR = "generated_masks/pretrain_1case_fuseunet_r1"
# cases listed in the reference's manifests whose files it does not ship
_ABSENT_VAL = (1, 2, 3, 5, 8, 13, 15, 19, 20)
_ABSENT_TRAIN = (21, 22, 31, 32, 33, 34, 36, 38, 39) + tuple(range(40, 60))
_ABSENT_SLICES = 4


def _liver(rng: np.random.Generator, slices: int, size: int) -> np.ndarray:
    """(slices, size, size) bool: an ellipse that grows from nothing at the
    volume's ends to its full size in the middle slices."""
    cy, cx = rng.uniform(0.42, 0.58, 2) * size
    ry, rx = rng.uniform(0.2, 0.28, 2) * size
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((slices, size, size), bool)
    for s in range(slices):
        f = max(np.sin(np.pi * (s + 0.5) / slices) - 0.2, 0.0) / 0.8
        if f > 0:
            out[s] = ((yy - cy) / (ry * f)) ** 2 + ((xx - cx) / (rx * f)) ** 2 <= 1.0
    return out


def _bootstrap(liver: np.ndarray) -> np.ndarray:
    """A pretrain's poor prediction of ``liver``: shifted down and right by
    7% and 4% of the image and cut at the organ's mid column."""
    size = liver.shape[-1]
    moved = np.roll(np.roll(liver, round(0.07 * size), -2), round(0.04 * size), -1)
    cols = np.nonzero(liver.any(axis=(0, 1)))[0]
    if cols.size:
        moved[:, :, : (cols[0] + cols[-1]) // 2] = False
    return moved


def _reference_rows(case, slices: int, mask_dir: str = ""):
    """Manifest rows (Inphase, Outphase, Mask) of ``case``, relative to
    All_Sets; the mask is the ground truth's unless ``mask_dir`` names
    another folder (relative to All_Sets) holding ``<case>/<stem>.png``."""
    series = f"{int(case):04d}"
    rows = []
    for s in range(slices):
        # the in-phase instance follows its out-phase one, as CHAOS numbers them
        stem = f"IMG-{series}-{2 * s + 2:05d}"
        base = f"{case}/T1DUAL"
        mask = f"{mask_dir}/{case}/{stem}.png" if mask_dir else f"{base}/Ground/{stem}.png"
        rows.append((f"{base}/DICOM_anon/InPhase/{stem}.dcm",
                     f"{base}/DICOM_anon/OutPhase/IMG-{series}-{2 * s + 1:05d}.dcm", mask))
    return rows


def write_reference_chaos(ref_dir: str, size: int = 256, seed: int = 0) -> dict:
    """Write, from ``seed``, the reference's CHAOS files that the real-data
    programs read, under ``ref_dir`` in the reference's layout:

    - ``inputs_chaos/All_Sets/{37,10}/T1DUAL/DICOM_anon/{InPhase,OutPhase}/
      IMG-*.dcm`` (``size`` x ``size`` px, the out-phase instance one below
      the in-phase one) and ``.../T1DUAL/Ground/<in-phase stem>.png``
      (palette PNGs, liver gray 63, a second class 126): case 37 with 30
      slice pairs, case 10 with 50;
    - ``inputs_chaos/All_Sets/generated_masks/pretrain_1case_fuseunet_r1/10/
      <in-phase stem>.png``: case 10's bootstrap pseudo-labels in the
      tempmask format (gray 63), each a shifted and cut copy of the ground
      truth; their 3D Dice against it is 0.5328 at 256 px and 0.5773 at
      32 px for seed 0 (the reference's own measure 0.479);
    - ``inputs_chaos/All_Sets_split/``: ``splitimages_cleanlabel/
      train_data_1cases.csv`` (case 37), ``splitimages_cleanlabel/
      val_data_10cases.csv`` (case 10 among nine other validation cases)
      and ``splitimages_pseudolabels_1pretrain/train_data_30cases.csv``
      (case 37's ground truth among 29 other cases whose masks point into
      the pseudo-label folder), each ``Inphase,Outphase,Mask`` with paths
      relative to All_Sets. The other cases' files are absent, as in the
      reference, where only cases 10 and 37 ship images.

    Returns the ``root`` (All_Sets) and ``split`` (All_Sets_split) paths
    and ``pseudo_dice``, the bootstrap labels' 3D Dice against case 10's
    ground truth."""
    from aide_tpu_torch.data.tasks.chaos import PALETTE

    rng = np.random.default_rng(seed)
    root = os.path.join(ref_dir, "inputs_chaos", "All_Sets")
    split = os.path.join(ref_dir, "inputs_chaos", "All_Sets_split")
    rows, pseudo_dice = {}, None
    for case, slices in REFERENCE_CASES:
        liver = _liver(rng, slices, size)
        # a second class (gray 126) in the lower left quadrant, outside the liver
        second = np.zeros_like(liver)
        second[:, size // 2:, : size // 2] = _organ(rng, slices, size // 2, size // 2)
        second &= ~liver
        rows[case] = _reference_rows(case, slices)
        for s, (inphase, outphase, mask) in enumerate(rows[case]):
            for rel, gain in ((inphase, 420.0), (outphase, 300.0)):
                write_dicom(_path(root, rel), _image(rng, liver[s] | second[s], 120.0, gain))
            write_palette_png(_path(root, mask), liver[s] * 1 + second[s] * 2, PALETTE)
        if case == "10":
            boot = _bootstrap(liver)
            for (inphase, _, _), sl in zip(rows[case], boot):
                stem = os.path.basename(inphase).split(".")[0]
                png.write_mask(_path(root, f"{REFERENCE_PSEUDO_DIR}/10/{stem}.png"), sl, scale=63)
            inter = np.count_nonzero(boot & liver)
            pseudo_dice = 2.0 * inter / (np.count_nonzero(boot) + np.count_nonzero(liver))

    def absent(cases, mask_dir=""):
        return {str(c): _reference_rows(c, _ABSENT_SLICES, mask_dir) for c in cases}

    def listed(by_case):
        return [row for c in sorted(by_case, key=int) for row in by_case[c]]

    header = ("Inphase", "Outphase", "Mask")
    clean = os.path.join(split, "splitimages_cleanlabel")
    # pandas' line ends, as the reference's manifests were written
    _write_csv(os.path.join(clean, "train_data_1cases.csv"), header, rows["37"], os.linesep)
    _write_csv(os.path.join(clean, "val_data_10cases.csv"), header,
               listed({**absent(_ABSENT_VAL), "10": rows["10"]}), os.linesep)
    _write_csv(os.path.join(split, "splitimages_pseudolabels_1pretrain", "train_data_30cases.csv"),
               header, listed({**absent(_ABSENT_TRAIN, REFERENCE_PSEUDO_DIR), "37": rows["37"]}),
               os.linesep)
    return {"root": root, "split": split, "pseudo_dice": pseudo_dice}
