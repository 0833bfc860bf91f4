"""Grayscale PNG mask IO with zlib, struct and numpy only.

The port's counterpart of ``aide_tpu.data.io.png.read_mask`` and
``write_mask``, without Pillow: the refreshed working labels ("tempmasks")
are 8-bit grayscale PNGs, and a machine that trains on the card need not
have Pillow. ``write_mask`` writes one IDAT of unfiltered rows at zlib
level 1, as Pillow's ``compress_level=1`` does: a refresh rewrites many
near-constant masks per epoch. ``read_mask`` reads any non-interlaced 8-bit
grayscale PNG, whatever row filters its writer chose (Pillow picks them
adaptively), and raises ``ValueError`` for every other kind.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def write_mask(path: str, mask: np.ndarray, scale: int = 63) -> None:
    """Write a binary/class-index mask as intensity * scale."""
    arr = np.ascontiguousarray((np.asarray(mask) * scale).astype(np.uint8))
    if arr.ndim != 2:
        raise ValueError(f"a mask is (H, W), got shape {arr.shape}")
    h, w = arr.shape
    # bit depth 8, colour type 0 (grayscale), deflate, filter method 0, no interlace
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1)  # filter type 0
    with open(path, "wb") as fh:
        fh.write(
            _SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b"")
        )


def _paeth(a: int, b: int, c: int) -> int:
    """The Paeth predictor: a (left), b (up), c (up-left)."""
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the per-row filters 0-4 of a 1-byte-per-pixel image."""
    if len(raw) != h * (w + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {h * (w + 1)}")
    data = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:  # none
            row = line.copy()
        elif kind == 1:  # sub: a running sum along the row, mod 256
            row = (np.cumsum(line, dtype=np.int64) & 0xFF).astype(np.uint8)
        elif kind == 2:  # up
            row = line + prev
        elif kind in (3, 4):  # average, Paeth: each pixel needs its left one decoded
            vals, up = line.tolist(), prev.tolist()
            dec = [0] * w
            left = upleft = 0
            for x in range(w):
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], upleft)
                left = dec[x] = (vals[x] + pred) & 0xFF
                upleft = up[x]
            row = np.asarray(dec, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prev = row
    return out


def read_mask(path: str) -> np.ndarray:
    """Read an 8-bit grayscale mask PNG as (H, W) uint8 intensity values."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path!r} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if (depth, colour, compression, filtering, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path!r} is not a non-interlaced 8-bit grayscale PNG (bit depth "
            f"{depth}, colour type {colour}, interlace {interlace})"
        )
    return _unfilter(zlib.decompress(b"".join(idat)), h, w)
