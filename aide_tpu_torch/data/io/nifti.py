"""Minimal NIfTI-1 reader/writer (.nii / .nii.gz).

An own copy of ``aide_tpu.data.io.nifti`` (gzip, struct and numpy only).
The reference's kidney and breast loaders go through
``SimpleITK.ReadImage`` + ``GetArrayFromImage``
(datasetkidney_comparison/dataset.py:28-46) and the kidney proposed
trainers write refreshed working labels as ``*_netK.nii.gz``
(train_files/trainkidney_proposed_mask1.py:404-434). SimpleITK is not a
dependency, so this module implements the NIfTI-1 container directly.
Arrays use the SimpleITK (z, y, x) axis convention so loaders keep
identical slicing semantics.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        import zlib

        try:
            data = gzip.decompress(data)
        except (OSError, EOFError, zlib.error) as e:
            # mid-stream truncation raises EOFError, bad gzip framing
            # OSError, and corrupt deflate blocks zlib.error (NOT an
            # OSError); normalize all to the reader contract (clean
            # ValueError, never a partial decode)
            raise ValueError(f"{path}: corrupt/truncated gzip stream: {e}")
    return data


def read_nifti(path: str) -> np.ndarray:
    """Read a NIfTI-1 volume as a (z, y, x) array (scl slope/inter applied
    when set)."""
    data = _open_bytes(path)
    if len(data) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", data[:4])[0]
    if sizeof_hdr == 348:
        end = "<"
    elif struct.unpack(">i", data[:4])[0] == 348:
        end = ">"
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    magic = data[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack(end + "8h", data[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid NIfTI dim[0]={ndim} (want 1..7)")
    shape_xyz = tuple(int(d) for d in dim[1 : 1 + ndim])
    if any(d < 1 for d in shape_xyz):
        # negative/zero extents would flow into a negative frombuffer count
        # (-1 reads EVERYTHING) — silent garbage, not an error
        raise ValueError(f"{path}: invalid NIfTI dims {shape_xyz}")
    datatype = struct.unpack(end + "h", data[70:72])[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    vox_offset_f = struct.unpack(end + "f", data[108:112])[0]
    if (
        not np.isfinite(vox_offset_f)
        or vox_offset_f < 0.0
        or (0.0 < vox_offset_f < 352.0)
    ):
        # junk offsets pointing INTO the header would silently decode header
        # bytes as voxels (the single-file minimum is 352: 348-byte header +
        # 4-byte extension indicator; 0 means "use the default 352")
        raise ValueError(f"{path}: invalid vox_offset {vox_offset_f}")
    vox_offset = int(vox_offset_f)
    scl_slope = struct.unpack(end + "f", data[112:116])[0]
    scl_inter = struct.unpack(end + "f", data[116:120])[0]

    dt = np.dtype(_DTYPES[datatype]).newbyteorder(end)
    count = int(np.prod(shape_xyz))
    offset = vox_offset or 352
    if offset + count * dt.itemsize > len(data):
        raise ValueError(
            f"{path}: truncated NIfTI payload (need {count * dt.itemsize} "
            f"bytes at offset {offset}, file holds {len(data)})"
        )
    arr = np.frombuffer(data, dtype=dt, count=count, offset=offset)
    # NIfTI data is x-fastest; reshape Fortran-style then reverse to (z,y,x)
    arr = arr.reshape(shape_xyz, order="F")
    arr = np.transpose(arr, tuple(range(arr.ndim))[::-1])
    # NaN slope/inter mean "no scaling" (common in real headers); without
    # the finiteness guard arr*NaN would silently corrupt the whole volume
    if not np.isfinite(scl_slope):
        scl_slope = 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    # the NIfTI-1 spec: scl_slope == 0 means NO scaling at all — the
    # intercept is ignored too (CT converters leave junk inter like -1024)
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        arr = arr.astype(np.float32) * scl_slope + scl_inter
    return np.ascontiguousarray(arr)


def write_nifti(
    path: str,
    volume: np.ndarray,
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> None:
    """Write a (z, y, x) array as NIfTI-1 (.nii, or .nii.gz when the path
    ends with .gz)."""
    vol = np.asarray(volume)
    if vol.dtype not in _CODES:
        vol = vol.astype(np.float32)
    code = _CODES[np.dtype(vol.dtype)]
    # back to x-fastest on disk
    xyz = np.transpose(vol, tuple(range(vol.ndim))[::-1])
    ndim = xyz.ndim
    dim = [ndim] + list(xyz.shape) + [1] * (7 - ndim)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, vol.dtype.itemsize * 8)  # bitpix
    pixdim = [1.0] + list(voxel_size[::-1])[:ndim] + [0.0] * (7 - ndim)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + xyz.tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as fh:
            fh.write(payload)
    else:
        with open(path, "wb") as fh:
            fh.write(payload)
