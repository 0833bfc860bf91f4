"""Fused TTA rotate/flip warp: a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``aide_tpu/ops/pallas_warp.py::_warp_kernel``
(launched by ``_shear_core``, wrapped by ``warp_rotate_flip``). Both compute
``ops.warp.augment`` / ``invert`` (shear method): an exact rot90 when
|theta| > 45 degrees, three Paeth shears (1-D bilinear resamples along x by
-tan(theta/2)*(row-c), along y by sin(theta)*(col-c), along x again) with a
fill value outside the source at every stage, and an hflip. Forward order:
rot90, shear, hflip. Inverse order (theta negated before rot90 is chosen):
hflip, rot90, shear.

What bounds it on an H100: device-memory bytes. Each output pixel is a
fixed composition of three lerps, 2 taps a stage, so 8 source reads and a
few dozen flops per channel; one input read and one output write per
element is the floor. At the CHAOS point one co-teaching step warps
2 x (32, 256, 256, 3) f32 forward and (64, 256, 256, 2) f32 inverse:
2 x (25.2 + 25.2) MB + (33.6 + 33.6) MB = 168 MB.

What the design does about it: the Pallas body keeps a whole (H, W) slice
in VMEM and shears it with log2(N) masked rolls; a 256^2 f32 slice (256 KiB)
does not fit a block's 227 KB of shared memory, and 512 px slices are 1 MiB.
So the kernel computes each output pixel (n, y, x) directly, one thread per
pixel looping over C, from the 8 source taps, which neighbouring threads
share through L1/L2. rot90, hflip and the NHWC<->NCHW transposes of the
Pallas wrapper fold into the source index math: the kernel reads and writes
NHWC (the memory of a channels_last NCHW tensor) with no copy.

``warp_rotate_flip`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``warp_plain``, the same 8-tap function in
plain PyTorch ops, which the tests hold to the JAX package and the chip
smoke run holds the kernel to. No library call computes this function
(``F.grid_sample`` is the gather resampler of ``ops.warp.sample_affine``,
a different function).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import torch

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "warp_rotate_flip.cu",
)
# build output lives beside the package, in a directory .gitignore lists
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "kernels",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: the coordinate d = lam*(j - c) and the lerps
    # round exactly as the plain version's separate multiply and add
    "-fmad=false",
)

# Kernel launches since the last reset; only the wrapper's launch adds to it.
launches = 0

_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


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
    """Scalar, (C,) or (N, C) fill -> contiguous (N, C) f32 on ``device``."""
    f = torch.as_tensor(fill, dtype=torch.float32, device=device)
    if f.ndim == 1:
        f = f[None, :]
    elif f.ndim == 0:
        f = f.reshape(1, 1)
    return f.expand(n, c).contiguous()


# ----------------------------- plain version -----------------------------


def warp_plain(
    images: torch.Tensor, table: torch.Tensor, fill: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """The kernel's 8-tap function in plain PyTorch: (N, S, S, C) f32 in,
    (N, S, S, C) f32 out. Same index math, same operation order."""
    n, s, _, c = images.shape
    dev = images.device
    cen = (s - 1) / 2.0
    lam_x = table[:, 0].reshape(n, 1, 1)
    lam_y = table[:, 1].reshape(n, 1, 1)
    n90 = table[:, 2].to(torch.int64).reshape(n, 1, 1)
    flip = (table[:, 3] > 0.5).reshape(n, 1, 1)
    ys = torch.arange(s, device=dev).reshape(1, s, 1).expand(n, s, s)
    xs = torch.arange(s, device=dev).reshape(1, 1, s).expand(n, s, s)
    if not inverse:
        xs = torch.where(flip, s - 1 - xs, xs)
    flat = images.reshape(n * s * s, c)
    base = (torch.arange(n, device=dev) * (s * s)).reshape(n, 1, 1)
    fill_b = fill.reshape(n, 1, 1, c)

    def inside(i):
        return (i >= 0) & (i <= s - 1)

    def split(lam, j):
        d = lam * (j.to(torch.float32) - cen)
        k = torch.floor(d)
        return k.to(torch.int64), (d - k)[..., None]

    def lerp(f, a, b):
        return (1.0 - f) * a + f * b

    def source(i, j):
        # u = rot90(v, n90); v = img, or hflip(img) on the inverse
        r = torch.where(n90 == 1, j, torch.where(n90 == -1, s - 1 - j, i))
        col = torch.where(n90 == 1, s - 1 - i, torch.where(n90 == -1, i, j))
        if inverse:
            col = torch.where(flip, s - 1 - col, col)
        idx = base + r.clamp(0, s - 1) * s + col.clamp(0, s - 1)
        return flat[idx.reshape(-1)].reshape(n, s, s, c)

    def stage1(yy, xx):  # along x, shift by the row
        k, f = split(lam_x, yy)
        x0 = xx + k
        a = torch.where(inside(x0)[..., None], source(yy, x0), fill_b)
        b = torch.where(inside(x0 + 1)[..., None], source(yy, x0 + 1), fill_b)
        return lerp(f, a, b)

    def stage2(yy, xx):  # along y, shift by the column
        k, f = split(lam_y, xx)
        y0 = yy + k
        a = torch.where(inside(y0)[..., None], stage1(y0, xx), fill_b)
        b = torch.where(inside(y0 + 1)[..., None], stage1(y0 + 1, xx), fill_b)
        return lerp(f, a, b)

    k, f = split(lam_x, ys)  # stage 3: along x, shift by the row
    x0 = xs + k
    a = torch.where(inside(x0)[..., None], stage2(ys, x0), fill_b)
    b = torch.where(inside(x0 + 1)[..., None], stage2(ys, x0 + 1), fill_b)
    return lerp(f, a, b)


# ----------------------------- the kernel -----------------------------


def build(verbose: bool = False) -> str:
    """Compile csrc/warp_rotate_flip.cu with nvcc (once per source hash)
    and return the shared library's path."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libwarp_rotate_flip_{key}.so")
    if os.path.exists(out):
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA warp kernel cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.warp_rotate_flip_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(
    images: torch.Tensor, table: torch.Tensor, fill: torch.Tensor, inverse: bool
) -> torch.Tensor:
    """Run the kernel on CUDA tensors: images (N, S, S, C) contiguous f32,
    table (N, 4) f32, fill (N, C) f32, all on one device."""
    global launches
    n, s, s2, c = images.shape
    if s != s2:
        raise ValueError(f"warp kernel needs a square image, got {s}x{s2}")
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
    out = torch.empty_like(images)
    if images.numel() == 0:
        return out
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().warp_rotate_flip_f32(
            images.data_ptr(), out.data_ptr(), table.data_ptr(), fill.data_ptr(),
            n, s, c, int(inverse), stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_rotate_flip kernel launch failed: CUDA error {err}")
    launches += 1
    return out


# ----------------------------- wrapper -----------------------------


def warp_rotate_flip(
    images: torch.Tensor,
    degrees: torch.Tensor,
    hflip: torch.Tensor,
    fill,
    inverse: bool = False,
) -> torch.Tensor:
    """Fused warp equivalent to ops.warp.augment / invert (shear method).

    images (B, H, W, C) with H == W, any float dtype (computed in f32 and
    cast back); degrees/hflip (B,); fill scalar | (C,) | (B, C). A CUDA
    tensor goes to the kernel, a CPU tensor to the plain version."""
    b, h, w, c = images.shape
    if h != w:
        raise ValueError(f"warp_rotate_flip needs a square image, got H={h}, W={w}")
    dev = images.device
    table = coef_table(degrees.to(dev), hflip.to(dev), inverse)
    fills = fill_table(fill, b, c, dev)
    x = images.to(torch.float32).contiguous()
    if dev.type == "cuda":
        out = launch(x, table, fills, inverse)
    elif dev.type == "cpu":
        out = warp_plain(x, table, fills, inverse)
    else:
        raise ValueError(f"warp_rotate_flip has no path for device {dev}")
    return out.to(images.dtype)


def bytes_moved(shape: Tuple[int, ...], itemsize: int = 4) -> int:
    """Least device-memory traffic of one call: input read once, output
    written once (the (N, 4) and (N, C) tables are negligible but counted)."""
    n, s, _, c = shape
    return 2 * n * s * s * c * itemsize + n * 4 * 4 + n * c * 4
