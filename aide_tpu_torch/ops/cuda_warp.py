"""Fused TTA rotate/flip warp: a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``aide_tpu/ops/pallas_warp.py::_warp_kernel``
(launched by ``_shear_core``, wrapped by ``warp_rotate_flip``). Both compute
``ops.warp.augment`` / ``invert`` (shear method): an exact rot90 when
|theta| > 45 degrees, three Paeth shears (1-D bilinear resamples along x by
-tan(theta/2)*(row-c), along y by sin(theta)*(col-c), along x again) with a
fill value outside the source at every stage, and an hflip. Forward order:
rot90, shear, hflip. Inverse order (theta negated before rot90 is chosen):
hflip, rot90, shear.

What bounds it on an H100: its floor is device-memory bytes. Each output
pixel is a fixed composition of three lerps, 2 taps a stage, so 8 source
reads and a few dozen flops per channel; one input read and one output
write per element is the floor. At the CHAOS point one co-teaching step
warps 2 x (32, 256, 256, 3) f32 forward and (64, 256, 256, 2) f32 inverse:
2 x (25.2 + 25.2) MB + (33.6 + 33.6) MB = 168 MB. In practice it is bound
by instruction issue: the 8-tap index math (7 floors, 14 bounds checks)
runs for every pixel, and each channel of each tap is its own load.

What the design does about it: the Pallas body keeps a whole (H, W) slice
in VMEM and shears it with log2(N) masked rolls; a 256^2 f32 slice (256 KiB)
does not fit a block's 227 KB of shared memory. A first kernel computed
each output pixel in its own thread from 8 taps read straight from device
memory; a warp's taps lie along the rotated direction of the source (down
a source column when the rot90 is folded in), so its loads were scattered.
The kernel now takes one block per 32 x 32 output tile: it reduces the
exact box of source pixels that the tile's taps read, and where that box
is at most BOX_SIDE on a side (every tile at |degrees| <= 180; about 2.2x
the tile's area at 45 degrees) it copies the box into shared memory with
cp.async (a box row is one contiguous run of the NHWC source whatever the
rot90 and flip are, so the copy is coalesced), then gathers the taps from
shared memory. Past 180 degrees the residual angle passes 90 and a tile's
box can grow to the whole image (about 243 px of 256 at 269.5 degrees,
which no block's shared memory holds): such a tile takes the global-tap
path, each thread reading its taps from device memory with the same index
math, the first kernel's design (``global_tiles`` counts these tiles). A
block takes one path as a whole. A warp is one output row, so its stores
are one contiguous run. Its time goes to the per-pixel index math, twice
(footprint and gather), and to the gather's shared-memory loads, whose
addresses follow a rotated line of the box and so meet in the same banks;
PERF.md has the measurements.
rot90, hflip and the NHWC<->NCHW transposes of the Pallas wrapper fold into
the index math: the kernel reads and writes NHWC (the memory of a
channels_last NCHW tensor) with no copy. ``source_boxes`` is the tile boxes
in plain PyTorch, from the same index math as ``warp_plain``.

A launch may write a window of output rows [row0, row0 + rows) alone (a
space shard's rows, ``rows`` = (row0, rows) in the wrapper): the grid then
covers only the window's tiles, and each tile's index math and source box
are the whole warp's at its global rows, so the window is exactly that
slice of the whole warp; the source stays the whole image.

``warp_rotate_flip`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``warp_plain``, the same 8-tap function in
plain PyTorch ops, which the tests hold to the JAX package and the chip
smoke run holds the kernel to. No library call computes this function
(``F.grid_sample`` is the gather resampler of ``ops.warp.sample_affine``,
a different function).
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Tuple

import torch

from aide_tpu_torch.core import trace
from aide_tpu_torch.ops import nvcc

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "warp_rotate_flip.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: the coordinate d = lam*(j - c) and the lerps
    # round exactly as the plain version's separate multiply and add
    "-fmad=false",
)

# Output tile side of the kernel and the largest side of a tile's source box
# that the kernel stages in shared memory (kTile and kBoxSide in the source;
# the tests read both there, and the loaded library's shared-memory size is
# checked against smem_bytes). A larger box takes the global-tap path.
TILE = 32
# Dynamic shared memory a block may have on an H100 (227 KB).
SMEM_LIMIT = 232448
# The grid's z dimension is the image index.
MAX_IMAGES = 65535


def box_side(tile: int = TILE) -> int:
    """Bound on the side, in source pixels, of the box that the read taps of
    a tile x tile output tile span, for residual angles |theta| <= 90 degrees
    (|degrees| <= 180 before the rot90): the staged path's box (BOX_SIDE).
    Past that the box is unbounded up to the image, and a tile whose box
    passes BOX_SIDE takes the kernel's global-tap path.

    With u, v the output column and row less the centre, the three shears
    give the source column X1 = cos*u - sin*v + cos*e3 + lam_x*e2 + e1 and
    row Y2 = sin*u + cos*v + lam_y*e3 + e2, where each e in (-1, 1] is a
    floor plus its tap. Over a tile that is at most (tile-1)*(|cos|+|sin|)
    + 2*(|cos| + |lam_x| + 1) columns and (tile-1)*(|cos|+|sin|) +
    2*(|sin| + 1) rows (48.1 for 32 px, at 45 degrees). An interval that
    long holds floor(L) + 1 integers; one more pixel covers the f32
    rounding of lam*(j - c)."""
    span = 0.0
    for i in range(9001):
        th = 0.5 * math.pi * i / 9000
        c, s, t = math.cos(th), math.sin(th), math.tan(th / 2.0)
        rot = (tile - 1) * (c + s)
        span = max(span, rot + 2.0 * (c + t + 1.0), rot + 2.0 * (s + 1.0))
    return int(math.floor(span)) + 2


BOX_SIDE = box_side()


def smem_bytes(c: int) -> int:
    """Dynamic shared memory of one block: BOX_SIDE rows of the staged box
    at an odd pitch of floats, then the C fill values
    (warp_rotate_flip_smem_bytes in the source)."""
    return (BOX_SIDE * ((BOX_SIDE * c) | 1) + c) * 4


_lib = None


# ----------------------------- parameters -----------------------------


def coef_table(degrees: torch.Tensor, hflip: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(N,) degrees and flips -> (N, 4) f32 table [lam_x, lam_y, n90, flip].

    lam_x = -tan(theta/2) and lam_y = sin(theta) of the residual angle after
    the exact 90-degree part, all in f32 torch ops, so the kernel and the
    plain version read the same values."""
    deg = degrees.to(torch.float32)
    if inverse:
        deg = -deg
    n90 = torch.where(
        deg > 45.0,
        torch.ones_like(deg),
        torch.where(deg < -45.0, -torch.ones_like(deg), torch.zeros_like(deg)),
    )
    rad = torch.deg2rad(deg - 90.0 * n90)
    flip = (hflip.to(torch.float32) > 0.5).to(torch.float32)
    return torch.stack([-torch.tan(rad / 2.0), torch.sin(rad), n90, flip], dim=1)


def fill_table(fill, n: int, c: int, device) -> torch.Tensor:
    """Scalar, (C,) or (N, C) fill -> contiguous (N, C) f32 on ``device``.
    A Python number is filled in on the device, with no copy from the host."""
    if isinstance(fill, (int, float)):
        return torch.full((n, c), float(fill), dtype=torch.float32, device=device)
    f = torch.as_tensor(fill, dtype=torch.float32, device=device)
    if f.ndim == 1:
        f = f[None, :]
    elif f.ndim == 0:
        f = f.reshape(1, 1)
    return f.expand(n, c).contiguous()


# ----------------------------- plain version -----------------------------


def _window(s: int, rows) -> Tuple[int, int]:
    """(row0, rows) of an output window; None is the whole image."""
    row0, n = (0, s) if rows is None else rows
    if not (0 <= row0 and n >= 0 and row0 + n <= s):
        raise ValueError(f"output rows [{row0}, {row0 + n}) outside an image of {s}")
    return row0, n


def _taps(table: torch.Tensor, s: int, inverse: bool, rows=None):
    """The kernel's index math for every output pixel of (N, R, S), the
    output rows ``rows`` = (row0, R) (None: all S).

    Returns (f3, taps): f3 the stage-3 fraction, (N, R, S, 1), and taps
    nested as [(v3, f2, [(v2, f1, [(v1, r, col)] * 2)] * 2)] * 2 over
    t3, t2, t1: each stage's validity and fraction, and the source pixel
    (r, col) of every stage-1 tap (clamped into the image; only read when
    v3, v2 and v1 hold)."""
    n = table.shape[0]
    dev = table.device
    row0, nr = _window(s, rows)
    cen = (s - 1) / 2.0
    lam_x = table[:, 0].reshape(n, 1, 1)
    lam_y = table[:, 1].reshape(n, 1, 1)
    n90 = table[:, 2].to(torch.int64).reshape(n, 1, 1)
    flip = (table[:, 3] > 0.5).reshape(n, 1, 1)
    ys = torch.arange(row0, row0 + nr, device=dev).reshape(1, nr, 1).expand(n, nr, s)
    xs = torch.arange(s, device=dev).reshape(1, 1, s).expand(n, nr, s)
    if not inverse:
        xs = torch.where(flip, s - 1 - xs, xs)

    def inside(i):
        return (i >= 0) & (i <= s - 1)

    def split(lam, j):
        d = lam * (j.to(torch.float32) - cen)
        k = torch.floor(d)
        return k.to(torch.int64), (d - k)[..., None]

    def source(i, j):
        # u = rot90(v, n90); v = img, or hflip(img) on the inverse
        r = torch.where(n90 == 1, j, torch.where(n90 == -1, s - 1 - j, i))
        col = torch.where(n90 == 1, s - 1 - i, torch.where(n90 == -1, i, j))
        if inverse:
            col = torch.where(flip, s - 1 - col, col)
        return r.clamp(0, s - 1), col.clamp(0, s - 1)

    k3, f3 = split(lam_x, ys)  # stage 3: along x, shift by the row
    taps = []
    for t3 in (0, 1):
        x3 = xs + k3 + t3
        k2, f2 = split(lam_y, x3)  # stage 2: along y, shift by the column
        row3 = []
        for t2 in (0, 1):
            y2 = ys + k2 + t2
            k1, f1 = split(lam_x, y2)  # stage 1: along x, shift by the row
            row2 = []
            for t1 in (0, 1):
                x1 = x3 + k1 + t1
                row2.append((inside(x1), *source(y2, x1)))
            row3.append((inside(y2), f1, row2))
        taps.append((inside(x3), f2, row3))
    return f3, taps


def warp_plain(
    images: torch.Tensor, table: torch.Tensor, fill: torch.Tensor, inverse: bool, rows=None
) -> torch.Tensor:
    """The kernel's 8-tap function in plain PyTorch: (N, S, S, C) f32 in,
    (N, R, S, C) f32 out, the output rows ``rows`` = (row0, R) (None: all
    S). Same index math, same operation order; every pixel is computed
    alone, so a window is exactly a slice of the whole warp."""
    n, s, _, c = images.shape
    nr = _window(s, rows)[1]
    flat = images.reshape(n * s * s, c)
    base = (torch.arange(n, device=images.device) * (s * s)).reshape(n, 1, 1)
    fill_b = fill.reshape(n, 1, 1, c)

    def lerp(f, a, b):
        return (1.0 - f) * a + f * b

    def tap(v, r, col):
        src = flat[(base + r * s + col).reshape(-1)].reshape(n, nr, s, c)
        return torch.where(v[..., None], src, fill_b)

    f3, taps = _taps(table, s, inverse, rows)
    s2 = []
    for v3, f2, row3 in taps:
        s1 = [torch.where(v2[..., None], lerp(f1, tap(*row2[0]), tap(*row2[1])), fill_b)
              for v2, f1, row2 in row3]
        s2.append(torch.where(v3[..., None], lerp(f2, *s1), fill_b))
    return lerp(f3, *s2)


def source_boxes(table: torch.Tensor, s: int, inverse: bool, tile: int = TILE,
                 rows=None) -> torch.Tensor:
    """Every tile x tile output tile's exact source box over the taps the
    kernel reads: (N, T_r, T, 4) int64 [r0, r1, c0, c1] with T = ceil(S/tile)
    and T_r = ceil(R/tile) tile rows of the output window ``rows`` = (row0,
    R) (None: all S), r0 > r1 where the tile reads no tap (it lies wholly
    in the fill). The same index math as warp_plain; a tile whose box
    passes BOX_SIDE on a side takes the kernel's global-tap path."""
    n = table.shape[0]
    nr = _window(s, rows)[1]
    t, t_r = -(-s // tile), -(-nr // tile)
    big = 1 << 30
    lo_r = torch.full((n, nr, s), big, dtype=torch.int64, device=table.device)
    hi_r = torch.full_like(lo_r, -big)
    lo_c, hi_c = lo_r.clone(), hi_r.clone()
    _, taps = _taps(table, s, inverse, rows)
    for v3, _, row3 in taps:
        for v2, _, row2 in row3:
            for v1, r, col in row2:
                read = v3 & v2 & v1
                lo_r = torch.minimum(lo_r, torch.where(read, r, big))
                hi_r = torch.maximum(hi_r, torch.where(read, r, -big))
                lo_c = torch.minimum(lo_c, torch.where(read, col, big))
                hi_c = torch.maximum(hi_c, torch.where(read, col, -big))

    def per_tile(a, fill_value, reduce):
        a = torch.nn.functional.pad(a, (0, t * tile - s, 0, t_r * tile - nr), value=fill_value)
        a = a.reshape(n, t_r, tile, t, tile).transpose(2, 3).reshape(n, t_r, t, tile * tile)
        return reduce(a, dim=-1)

    return torch.stack([
        per_tile(lo_r, big, torch.amin), per_tile(hi_r, -big, torch.amax),
        per_tile(lo_c, big, torch.amin), per_tile(hi_c, -big, torch.amax),
    ], dim=-1)


def global_tiles(boxes: torch.Tensor) -> int:
    """Tiles of a launch that take the kernel's global-tap path, from the
    launch's ``source_boxes``: those whose box passes BOX_SIDE on a side. A
    tile that reads no tap stages nothing and counts as staged. Plain
    PyTorch; the kernel itself counts nothing."""
    read = boxes[..., 0] <= boxes[..., 1]
    big = ((boxes[..., 1] - boxes[..., 0] + 1 > BOX_SIDE)
           | (boxes[..., 3] - boxes[..., 2] + 1 > BOX_SIDE))
    return int((read & big).sum())


# ----------------------------- the kernel -----------------------------


def build(verbose: bool = False, source: str = SOURCE) -> str:
    """Compile ``source`` (csrc/warp_rotate_flip.cu) with nvcc, once per
    source hash, and return the shared library's path."""
    return nvcc.build(source, "warp_rotate_flip", NVCC_FLAGS, verbose)


def load(path: str):
    """ctypes handle of a built library, with warp_rotate_flip_f32 typed
    (in, out, table, fill, n_img, s, c, inverse, row0, rows, stream)."""
    lib = ctypes.CDLL(path)
    fn = lib.warp_rotate_flip_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = load(build())
        fn = lib.warp_rotate_flip_smem_bytes
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        for c in range(1, 9):
            if fn(c) != smem_bytes(c):
                raise RuntimeError(
                    f"the kernel takes {fn(c)} bytes of shared memory at C={c}; "
                    f"launch sizes {smem_bytes(c)} (BOX_SIDE {BOX_SIDE})"
                )
        _lib = lib
    return _lib


def launch(
    images: torch.Tensor, table: torch.Tensor, fill: torch.Tensor, inverse: bool, rows=None
) -> torch.Tensor:
    """Run the kernel on CUDA tensors: images (N, S, S, C) contiguous f32,
    table (N, 4) f32, fill (N, C) f32, all on one device; the (N, R, S, C)
    output rows ``rows`` = (row0, R) (None: all S). Each launch adds one
    to the ``warp.launches`` counter (``core.trace``)."""
    n, s, s2, c = images.shape
    if s != s2:
        raise ValueError(f"warp kernel needs a square image, got {s}x{s2}")
    row0, nr = _window(s, rows)
    if smem_bytes(c) > SMEM_LIMIT:
        raise ValueError(
            f"C={c}: a {BOX_SIDE}x{BOX_SIDE} source box takes {smem_bytes(c)} bytes of "
            f"shared memory, over the {SMEM_LIMIT} a block may have"
        )
    if n > MAX_IMAGES:
        raise ValueError(f"warp kernel takes at most {MAX_IMAGES} images a launch, got {n}")
    if s * s * c >= 1 << 31:
        raise ValueError(f"warp kernel indexes an image in 32 bits, got {s}x{s}x{c}")
    for name, t, shape in (
        ("images", images, (n, s, s, c)),
        ("table", table, (n, 4)),
        ("fill", fill, (n, c)),
    ):
        if not t.is_cuda or t.device != images.device:
            raise ValueError(f"{name} must be on {images.device}, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    out = images.new_empty((n, nr, s, c))
    if out.numel() == 0:
        return out
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().warp_rotate_flip_f32(
            images.data_ptr(), out.data_ptr(), table.data_ptr(), fill.data_ptr(),
            n, s, c, int(inverse), row0, nr, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_rotate_flip kernel launch failed: CUDA error {err}")
    trace.add("warp.launches")
    return out


# ----------------------------- wrapper -----------------------------


def warp_rotate_flip(
    images: torch.Tensor,
    degrees: torch.Tensor,
    hflip: torch.Tensor,
    fill,
    inverse: bool = False,
    rows=None,
) -> torch.Tensor:
    """Fused warp equivalent to ops.warp.augment / invert (shear method).

    images (B, H, W, C) with H == W, any float dtype (computed in f32 and
    cast back); degrees/hflip (B,); fill scalar | (C,) | (B, C); ``rows``
    = (row0, R) returns output rows [row0, row0 + R) alone, (B, R, W, C)
    (None: all of them). A CUDA tensor goes to the kernel, at any angle;
    a CPU tensor goes to the plain version."""
    b, h, w, c = images.shape
    if h != w:
        raise ValueError(f"warp_rotate_flip needs a square image, got H={h}, W={w}")
    dev = images.device
    table = coef_table(degrees.to(dev), hflip.to(dev), inverse)
    fills = fill_table(fill, b, c, dev)
    x = images.to(torch.float32).contiguous()
    if dev.type == "cuda":
        out = launch(x, table, fills, inverse, rows)
    elif dev.type == "cpu":
        out = warp_plain(x, table, fills, inverse, rows)
    else:
        raise ValueError(f"warp_rotate_flip has no path for device {dev}")
    return out.to(images.dtype)


def bytes_moved(shape: Tuple[int, ...], itemsize: int = 4) -> int:
    """Least device-memory traffic of one call: input read once, output
    written once (the (N, 4) and (N, C) tables are negligible but counted)."""
    n, s, _, c = shape
    return 2 * n * s * s * c * itemsize + n * 4 * 4 + n * c * 4


def window_bytes_moved(table: torch.Tensor, s: int, c: int, inverse: bool, rows,
                       itemsize: int = 4) -> int:
    """Least device-memory traffic of a launch of the output rows ``rows``
    = (row0, R): every source pixel its taps read at these angles
    (``table``), read once, and the (N, R, S, C) output written once, plus
    the tables."""
    n = table.shape[0]
    read = torch.zeros(n * s * s, dtype=torch.bool, device=table.device)
    base = (torch.arange(n, device=table.device) * (s * s)).reshape(n, 1, 1)
    _, taps = _taps(table, s, inverse, rows)
    for v3, _, row3 in taps:
        for v2, _, row2 in row3:
            for v1, r, col in row2:
                read[(base + r * s + col)[v3 & v2 & v1]] = True
    pixels = int(read.sum()) + n * _window(s, rows)[1] * s
    return pixels * c * itemsize + n * 4 * 4 + n * c * 4
