"""PNG mask and image IO with zlib, struct and numpy only.

The port's counterpart of ``aide_tpu.data.io.png``, without Pillow: a
machine that trains on the card need not have it. ``write_mask`` writes an
8-bit grayscale PNG, one IDAT of unfiltered rows at zlib level 1, as
Pillow's ``compress_level=1`` does: a refresh rewrites many near-constant
masks per epoch. ``read_mask`` returns what Pillow's ``convert("L")`` gives
for any non-interlaced PNG of at most 8 bits a sample: grayscale at bit
depth 1 (0 or 255), 2 (x 85), 4 (x 17) or 8; palette images through their
palette; gray+alpha without the alpha; RGB and RGBA as Pillow's luma
(R 299 + G 587 + B 114) / 1000, in its fixed point
(R 19595 + G 38470 + B 7471 + 2**15) >> 16. ``read_image_rgb`` returns
Pillow's ``convert("RGB")``. Interlaced and 16-bit files raise
``ValueError``, as does a palette index past the palette.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type: gray, RGB, palette, gray+alpha, RGBA
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# the bit depths the PNG specification allows for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters 0-4: ``stride`` bytes a row, the left
    neighbour ``bpp`` bytes back (1 for depths under 8)."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected {h * (stride + 1)}")
    data = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:  # none
            row = line.copy()
        elif kind == 1:  # sub: a running sum along each byte lane
            lanes = line.reshape(-1, bpp)
            row = (np.cumsum(lanes, axis=0, dtype=np.int64) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:  # up
            row = line + prev
        elif kind in (3, 4):  # average, Paeth: each byte needs its left one decoded
            vals, up = line.tolist(), prev.tolist()
            dec = [0] * stride
            for x in range(stride):
                left = dec[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - bpp] if x >= bpp else 0)
                dec[x] = (vals[x] + pred) & 0xFF
            row = np.asarray(dec, np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prev = row
    return out


def _decode(path: str) -> Tuple[int, int, np.ndarray, Optional[np.ndarray]]:
    """(colour type, bit depth, samples (H, W, S) uint8, palette (N, 3) or
    None). Samples under 8 bits come back as their integer values."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path!r} is not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{path!r} has an IHDR of {len(body)} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path!r} has no IHDR chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _SAMPLES or depth not in _DEPTHS[colour]:
        raise ValueError(f"{path!r}: invalid PNG bit depth {depth} for colour type {colour}")
    if depth == 16:
        raise ValueError(f"{path!r}: 16-bit PNGs are not supported (bit depth 16)")
    if interlace != 0:
        raise ValueError(f"{path!r}: interlaced PNGs are not supported (interlace {interlace})")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path!r}: unknown PNG compression {compression} or filter method {filtering}")
    if colour == 3 and palette is None:
        raise ValueError(f"{path!r}: a palette PNG without a PLTE chunk")
    samples = _SAMPLES[colour]
    stride = (w * samples * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path!r}: corrupt PNG image data: {e}")
    rows = _unfilter(raw, h, stride, max(1, samples * depth // 8))
    if depth < 8:
        # big-endian packed samples, most significant first; a row's spare
        # low bits are padding
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        rows = (bits * weights).sum(axis=-1).astype(np.uint8)[:, : w * samples]
    return colour, depth, rows.reshape(h, w, samples), palette


def _palette_rgb(path: str, index: np.ndarray, palette: np.ndarray) -> np.ndarray:
    if int(index.max(initial=0)) >= len(palette):
        raise ValueError(
            f"{path!r}: palette index {int(index.max())} past the palette's {len(palette)} entries"
        )
    return palette[index]


def _gray(colour: int, depth: int, px: np.ndarray) -> np.ndarray:
    """Grayscale samples at 8 bits as Pillow unpacks them: 1-bit images are
    mode '1' (0 or 255), 2- and 4-bit ones scale to 0..255."""
    gray = px[..., 0]
    if colour == 0 and depth < 8:
        return (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return gray


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: ITU-R 601-2 luma in 16-bit fixed point."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_mask(path: str) -> np.ndarray:
    """Read a mask PNG as (H, W) uint8 intensity values, as Pillow's
    ``convert("L")`` gives them."""
    colour, depth, px, palette = _decode(path)
    if colour in (0, 4):
        return _gray(colour, depth, px)
    if colour == 3:
        return _luma(_palette_rgb(path, px[..., 0], palette))
    return _luma(px[..., :3])


def read_image_rgb(path: str) -> np.ndarray:
    """Read a PNG as (H, W, 3) uint8, as Pillow's ``convert("RGB")`` gives it."""
    colour, depth, px, palette = _decode(path)
    if colour in (0, 4):
        return np.repeat(_gray(colour, depth, px)[..., None], 3, axis=-1)
    if colour == 3:
        return _palette_rgb(path, px[..., 0], palette)
    return np.ascontiguousarray(px[..., :3])
