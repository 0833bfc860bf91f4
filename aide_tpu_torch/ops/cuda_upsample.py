"""The decoders' 2x bilinear upsample: a hand-written CUDA kernel for Hopper
in each direction (``csrc/upsample2x.cu``).

Replaces no TPU kernel: the JAX package resizes with ``jax.image.resize``
(``aide_tpu/models/blocks.py``), a library call. It exists because the
library path on the card is slow where it sits: autocast lists
``upsample_bilinear2d`` as a float32 op, so under the models' bf16 region
each decoder level cast its bf16 input up to f32, ran ATen's f32 NHWC
kernel, and wrote an f32 map four times the input's size, which the next
convolution cast straight back to bf16; the backward cast the bf16
gradient up, scattered it with atomics into a zero-filled f32 buffer and
cast it down. In the kidney co-teaching step (UNet-64, 512 px) that was the
card's costliest kernel, at about a sixth of its byte bound, and the casts
around it cost most of as much again.

The function: upsample by 2 with half-pixel centres and the edge clamped
(``F.interpolate(mode="bilinear", align_corners=False)`` at scale 2, and
``jax.image.resize``'s bilinear). Along an axis of length L, output o
takes the taps (i0, i1) and weights (l0, l1): (k, min(k + 1, L - 1)) and
(0.75, 0.25) at o = 2k + 1; (k - 1, k) and (0.25, 0.75) at o = 2k, k >= 1;
(0, 0) and (1, 0) at o = 0. Every weight is exact. A pixel is
``lh0*(lw0*v00 + lw1*v01) + lh1*(lw0*v10 + lw1*v11)``, ATen's order, summed
in f32 (f64 for an f64 input on the CPU) and rounded once to the output's
dtype: the autocast dtype inside an autocast region, else the input's. So
the next convolution gets the operand that autocast's path gave it, and
its own cast is a no-op. The backward gathers: each input pixel sums its
4 x 4 output-gradient taps with the transposed weights, along W and then
along H, in f32, and writes the gradient once, in the input's dtype. It is
deterministic, as ATen's atomic backward is not.

What bounds it on an H100: device-memory bytes. The forward reads each
input element once and writes four outputs, with 3 flops an output; the
backward reads four gradient elements and writes one. The floor is those
bytes at 3.35 TB/s (``bytes_moved``). The forward's thread owns one input
2x2 block and a vector of up to 16 bytes of channels (8 bf16, 4 f32; 8, 4
or 2 bytes when C or the base address does not allow it): the block's four
loads give the four outputs of rows {2i - 1, 2i} and columns {2j - 1, 2j}
(``csrc/upsample2x.cu`` has the index math), so each output is written once
and the neighbours' loads of an input pixel come through L1/L2. The
backward's thread owns one input pixel's vector and reads its 16 taps the
same way. Both take and give NHWC memory, the channels_last NCHW tensors
the blocks hold, with no copy.

``upsample2x`` launches the kernels for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``upsample2x_plain`` and
``upsample2x_grad_plain``, the same functions in plain PyTorch ops (the same
index math, the same operation order, so on the card they equal the kernels
bit for bit), which the tests hold to ``F.interpolate`` and the chip smoke
run holds the kernels to. Each launch adds one to the ``upsample.launches``
counter (``core.trace``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from aide_tpu_torch.core import trace
from aide_tpu_torch.ops import nvcc

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc",
    "upsample2x.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: every product and sum rounds as the plain
    # version's separate multiplies and adds do
    "-fmad=false",
)
# the kernels' element types and their codes in the C entry points
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# the grid's y dimension is an input row (H + 1 of them), z an image
MAX_GRID_YZ = 65535

_lib = None


def _compute_dtype(*dtypes: torch.dtype) -> torch.dtype:
    return torch.float64 if torch.float64 in dtypes else torch.float32


# ----------------------------- plain version -----------------------------


def forward_taps(length: int, device=None) -> Tuple[torch.Tensor, ...]:
    """Outputs o in [0, 2 * length) along one axis: their taps (i0, i1),
    int64, and weights (l0, l1), float64 (exact in every dtype)."""
    o = torch.arange(2 * length, device=device)
    k = o // 2
    odd = o % 2 == 1
    i0 = torch.where(odd, k, (k - 1).clamp(min=0))
    i1 = torch.where(odd, (k + 1).clamp(max=length - 1), k)
    l0 = torch.where(odd, 0.75, torch.where(o == 0, 1.0, 0.25)).to(torch.float64)
    return i0, i1, l0, 1.0 - l0


def grad_taps(length: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inputs i in [0, length) along one axis: the output taps of their
    gradient, (4, length) int64 (2i - 1 .. 2i + 2, clamped into [0,
    2 * length)), and the transposed weights, (4, length) float64; a tap
    clamped in from outside has weight 0."""
    i = torch.arange(length, device=device)
    taps = torch.stack([(2 * i - 1).clamp(min=0), 2 * i, 2 * i + 1,
                        (2 * i + 2).clamp(max=2 * length - 1)])
    weights = torch.stack([torch.where(i >= 1, 0.25, 0.0), torch.where(i == 0, 1.0, 0.75),
                           torch.where(i == length - 1, 1.0, 0.75),
                           torch.where(i <= length - 2, 0.25, 0.0)])
    return taps, weights.to(torch.float64)


def upsample2x_plain(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: (N, H, W, C) in,
    (N, 2H, 2W, C) of ``out_dtype`` out; along W first, then along H, each
    output ``l0*a + l1*b`` as separate multiplies and an add."""
    ct = _compute_dtype(x.dtype, out_dtype)
    xf = x.to(ct)
    _, h, w, _ = x.shape
    i0, i1, l0, l1 = forward_taps(w, x.device)
    l0, l1 = l0.to(ct).view(2 * w, 1), l1.to(ct).view(2 * w, 1)
    a = l0 * xf.index_select(2, i0) + l1 * xf.index_select(2, i1)
    i0, i1, l0, l1 = forward_taps(h, x.device)
    l0, l1 = l0.to(ct).view(2 * h, 1, 1), l1.to(ct).view(2 * h, 1, 1)
    out = l0 * a.index_select(1, i0) + l1 * a.index_select(1, i1)
    return out.to(out_dtype)


def _gather(g: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """Along ``dim`` of g (2 * length long): each input's four taps
    weighted and summed left to right."""
    taps, weights = grad_taps(length, g.device)
    shape = (length,) + (1,) * (g.ndim - 1 - dim)
    acc = None
    for tap, weight in zip(taps, weights.to(g.dtype)):
        term = weight.view(shape) * g.index_select(dim, tap)
        acc = term if acc is None else acc + term
    return acc


def upsample2x_grad_plain(grad: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: the output's
    gradient (N, 2H, 2W, C) in, the input's (N, H, W, C) of ``in_dtype``
    out; along W first, then along H, in the kernel's order."""
    g = grad.to(_compute_dtype(grad.dtype, in_dtype))
    _, h2, w2, _ = grad.shape
    return _gather(_gather(g, 2, w2 // 2), 1, h2 // 2).to(in_dtype)


# ----------------------------- the kernels -----------------------------


def build(verbose: bool = False) -> str:
    """Compile csrc/upsample2x.cu with nvcc, once per source hash, and
    return the shared library's path."""
    return nvcc.build(SOURCE, "upsample2x", NVCC_FLAGS, verbose)


def load(path: str):
    """ctypes handle of a built library, with upsample2x_forward and
    upsample2x_backward typed (src, dst, src dtype code, dst dtype code,
    n, h, w, c, vec, stream)."""
    lib = ctypes.CDLL(path)
    for fn in (lib.upsample2x_forward, lib.upsample2x_backward):
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def vector_width(c: int, *tensors: torch.Tensor) -> int:
    """Channels a thread takes: the most of 8, 4, 2, 1 that divides C, is at
    most 16 bytes of every tensor's dtype and to whose bytes every
    tensor's base address is aligned."""
    for v in (8, 4, 2):
        if c % v == 0 and all(v * t.element_size() <= 16
                              and t.data_ptr() % (v * t.element_size()) == 0 for t in tensors):
            return v
    return 1


def _launch(forward: bool, src: torch.Tensor, dst: torch.Tensor, n: int, h: int, w: int,
            c: int) -> None:
    for name, t in (("source", src), ("output", dst)):
        if not t.is_cuda or t.device != src.device:
            raise ValueError(f"upsample2x kernel: {name} must be a CUDA tensor on {src.device}, "
                             f"got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"upsample2x kernel takes float32, float16 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"upsample2x kernel: {name} must be contiguous NHWC")
    if n > MAX_GRID_YZ or h + 1 > MAX_GRID_YZ:
        raise ValueError(f"upsample2x kernel takes at most {MAX_GRID_YZ} images and "
                         f"{MAX_GRID_YZ - 1} rows, got {n} x {h}")
    if (w + 1) * c >= 1 << 31:
        raise ValueError(f"upsample2x kernel indexes a row in 32 bits, got W={w}, C={c}")
    if dst.numel() == 0:
        return
    vec = vector_width(c, src, dst)
    lib = _library()
    fn = lib.upsample2x_forward if forward else lib.upsample2x_backward
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(src.data_ptr(), dst.data_ptr(), DTYPE_CODES[src.dtype], DTYPE_CODES[dst.dtype],
                 n, h, w, c, vec, stream)
    if err != 0:
        raise RuntimeError(f"upsample2x kernel launch failed: CUDA error {err}")
    trace.add("upsample.launches")


def launch_forward(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The forward kernel on a CUDA tensor: x (N, H, W, C) contiguous, in
    float32, float16 or bfloat16, to (N, 2H, 2W, C) of ``out_dtype``."""
    n, h, w, c = x.shape
    out = torch.empty((n, 2 * h, 2 * w, c), dtype=out_dtype, device=x.device)
    _launch(True, x, out, n, h, w, c)
    return out


def launch_backward(grad: torch.Tensor, in_dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel on a CUDA tensor: the output's gradient (N, 2H,
    2W, C) contiguous to the input's (N, H, W, C) of ``in_dtype``."""
    n, h2, w2, c = grad.shape
    if h2 % 2 or w2 % 2:
        raise ValueError(f"upsample2x backward needs an even output, got {h2}x{w2}")
    out = torch.empty((n, h2 // 2, w2 // 2, c), dtype=in_dtype, device=grad.device)
    _launch(False, grad, out, n, h2 // 2, w2 // 2, c)
    return out


# ----------------------------- wrapper -----------------------------


def _on_device(kernel, plain, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if t.device.type == "cuda":
        return kernel(t, dtype)
    if t.device.type == "cpu":
        return plain(t, dtype)
    raise ValueError(f"upsample2x has no path for device {t.device}")


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) as its (N, H, W, C) memory: a view of a channels_last
    tensor, a copy of any other."""
    return t.permute(0, 2, 3, 1).contiguous()


class Upsample2x(torch.autograd.Function):
    """(N, C, H, W) -> (N, C, 2H, 2W) channels_last of ``out_dtype``, and
    the gradient back in the input's dtype and memory format's NHWC."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        ctx.in_dtype = x.dtype
        out = _on_device(launch_forward, upsample2x_plain, _nhwc(x), out_dtype)
        return out.permute(0, 3, 1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        gx = _on_device(launch_backward, upsample2x_grad_plain, _nhwc(grad), ctx.in_dtype)
        return gx.permute(0, 3, 1, 2), None


def output_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype inside an autocast region on x's device (a
    float64 input excepted, which autocast leaves alone), else x's."""
    kind = x.device.type
    if (x.dtype != torch.float64 and torch.amp.is_autocast_available(kind)
            and torch.is_autocast_enabled(kind)):
        return torch.get_autocast_dtype(kind)
    return x.dtype


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres of an (N, C, H, W)
    tensor of any memory format: (N, C, 2H, 2W) in channels_last memory,
    in ``output_dtype(x)``. A CUDA tensor goes to the kernels, a CPU
    tensor to the plain versions."""
    return Upsample2x.apply(x, output_dtype(x))


def bytes_moved(shape: Tuple[int, int, int, int], in_itemsize: int, out_itemsize: int) -> int:
    """Least device-memory traffic of one launch in either direction at
    the input's (N, H, W, C): the input (or its gradient) once and the 4x
    output (or its gradient) once; ``in_itemsize`` is the input's dtype's,
    ``out_itemsize`` the output's."""
    n, h, w, c = shape
    elems = n * h * w * c
    return elems * in_itemsize + 4 * elems * out_itemsize
