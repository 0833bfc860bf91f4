"""Minimal NRRD reader (raw / gzip encodings).

An own copy of ``aide_tpu.data.io.nrrd``. The reference's prostate loaders
read ISBI NRRD volumes through SimpleITK
(datasetprostate_comparison/dataset.py:21-26). This parser
handles the detached-header-free .nrrd format: text header (``key: value``
lines up to a blank line) followed by the data blob. Arrays come back in the
SimpleITK (z, y, x) axis order.
"""

from __future__ import annotations

import gzip
import zlib
from typing import Dict, Tuple

import numpy as np

_TYPE_MAP = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "float": np.float32, "double": np.float64,
}


def read_nrrd(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Read an attached-data NRRD: returns ((z, y, x) array, header dict)."""
    with open(path, "rb") as fh:
        blob = fh.read()

    nl = blob.find(b"\n")
    if nl < 0 or not blob[:nl].startswith(b"NRRD"):
        raise ValueError(f"{path}: not an NRRD file")

    header: Dict[str, str] = {}
    i = nl + 1
    while True:
        j = blob.find(b"\n", i)
        if j < 0:
            raise ValueError(f"{path}: header never terminated")
        line = blob[i:j].rstrip(b"\r")
        i = j + 1
        if not line:
            break  # blank line ends the header
        if line.startswith(b"#"):
            continue
        for sep in (b": ", b":=", b":"):
            if sep in line:
                key, val = line.split(sep, 1)
                header[key.decode().strip().lower()] = (
                    val.decode(errors="replace").strip()
                )
                break

    # fields this attached-data parser cannot honor silently: a detached
    # data file means the blob after the header is NOT the voxels, and a
    # line skip shifts where the data starts — decoding anyway would return
    # garbage that trains downstream
    for k in ("data file", "datafile"):
        if k in header:
            raise ValueError(
                f"{path}: detached-data NRRD (data file: {header[k]!r}) "
                "is not supported — use attached-data .nrrd"
            )
    if int(header.get("line skip", header.get("lineskip", 0)) or 0) != 0:
        raise ValueError(f"{path}: nonzero NRRD line skip is not supported")

    typ = header.get("type", "float")
    if typ not in _TYPE_MAP:
        raise ValueError(f"{path}: unsupported NRRD type {typ!r}")
    dtype = np.dtype(_TYPE_MAP[typ])
    endian = header.get("endian", "little")
    dtype = dtype.newbyteorder("<" if endian == "little" else ">")

    if "sizes" not in header:
        raise ValueError(f"{path}: NRRD header missing 'sizes'")
    sizes = [int(s) for s in header["sizes"].split()]
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"{path}: invalid NRRD sizes {sizes}")
    encoding = header.get("encoding", "raw").lower()
    payload = blob[i:]
    # byte skip applies to the data segment before decoding; -1 means "the
    # payload is the LAST count*itemsize bytes" (raw only, per the spec)
    count = int(np.prod(sizes))
    byteskip = int(header.get("byte skip", header.get("byteskip", 0)) or 0)
    if byteskip == -1:
        if encoding != "raw":
            raise ValueError(
                f"{path}: byte skip -1 is only defined for raw encoding"
            )
        payload = payload[len(payload) - count * dtype.itemsize:]
    elif byteskip > 0:
        payload = payload[byteskip:]
    elif byteskip < 0:
        raise ValueError(f"{path}: invalid NRRD byte skip {byteskip}")
    try:
        if encoding in ("gzip", "gz"):
            payload = gzip.decompress(payload)
        elif encoding in ("zlib",):
            payload = zlib.decompress(payload)
        elif encoding not in ("raw",):
            raise ValueError(
                f"{path}: unsupported NRRD encoding {encoding!r}"
            )
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"{path}: corrupt/truncated {encoding} payload: {e}")

    if len(payload) < count * dtype.itemsize:
        raise ValueError(
            f"{path}: truncated NRRD payload (need "
            f"{count * dtype.itemsize} bytes, have {len(payload)})"
        )
    arr = np.frombuffer(payload, dtype=dtype, count=count)
    # NRRD sizes are fastest-axis-first (x, y, z) -> reshape F, return (z,y,x)
    arr = arr.reshape(sizes, order="F")
    arr = np.transpose(arr, tuple(range(arr.ndim))[::-1])
    return np.ascontiguousarray(arr), header


def write_nrrd(path: str, volume: np.ndarray, encoding: str = "gzip") -> None:
    """Write a (z, y, x) array as NRRD (for round-trip tests and temp-label
    mirroring)."""
    vol = np.asarray(volume)
    inv_types = {
        np.dtype(np.uint8): "uint8", np.dtype(np.int16): "int16",
        np.dtype(np.uint16): "uint16", np.dtype(np.int32): "int32",
        np.dtype(np.float32): "float", np.dtype(np.float64): "double",
    }
    if vol.dtype not in inv_types:
        vol = vol.astype(np.float32)
    xyz = np.transpose(vol, tuple(range(vol.ndim))[::-1])
    sizes = " ".join(str(s) for s in xyz.shape)
    hdr = (
        "NRRD0004\n"
        f"type: {inv_types[np.dtype(vol.dtype)]}\n"
        f"dimension: {xyz.ndim}\n"
        f"sizes: {sizes}\n"
        f"encoding: {encoding}\n"
        "endian: little\n"
        "\n"
    ).encode()
    payload = xyz.tobytes(order="F")
    if encoding == "gzip":
        payload = gzip.compress(payload)
    elif encoding != "raw":
        raise ValueError(f"unsupported encoding {encoding!r}")
    with open(path, "wb") as fh:
        fh.write(hdr + payload)
