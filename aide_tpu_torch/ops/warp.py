"""Batched affine warps (rotation + horizontal flip) on (B, H, W, C) tensors.

The counterpart of ``aide_tpu.ops.warp``: rotation about the image centre
with bilinear resampling and a constant fill outside the source extent
(rotate-then-flip forward, flip-then-unrotate inverse). Three
implementations compute it:

  * ``gather`` -- ``sample_affine``, a 4-corner bilinear gather through
    per-image 2x2 sampling matrices (the exactness reference);
  * ``shear``  -- an exact rot90 for |theta| > 45 degrees, then three Paeth
    shears, each a 1-D bilinear resample along one axis (plain PyTorch);
  * ``cuda``   -- the same shear function as one hand-written CUDA kernel
    (``ops.cuda_warp``); on a CPU tensor it runs the kernel's plain version.

``auto`` picks ``cuda`` for a CUDA tensor and ``shear`` for a CPU tensor.

``rows`` = (row0, R) asks for output rows [row0, row0 + R) alone: the rows
of a space shard (``core.mesh``), warped from the whole source. The kernel
(and its plain version) computes only the window; the ``shear`` and
``gather`` paths compute the whole warp and slice it.
"""

from __future__ import annotations

import torch

from aide_tpu_torch.ops import cuda_warp

METHODS = ("auto", "cuda", "shear", "gather")


# ----------------------------- gather path -----------------------------


def _rot_mats(degrees: torch.Tensor, sign: float) -> torch.Tensor:
    """(B,) degrees -> (B, 2, 2) rotation matrices R_{sign*theta}."""
    rad = torch.deg2rad(degrees.to(torch.float32)) * sign
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _flip_mats(hflip: torch.Tensor) -> torch.Tensor:
    """(B,) {0,1} -> (B, 2, 2) reflection about the vertical centre axis."""
    f = 1.0 - 2.0 * hflip.to(torch.float32)
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    return torch.stack(
        [torch.stack([f, zero], dim=-1), torch.stack([zero, one], dim=-1)], dim=-2
    )


def aug_matrices(degrees: torch.Tensor, hflip: torch.Tensor) -> torch.Tensor:
    """Sampling matrices of the forward flip(rotate(img, d)): M = R_d @ F."""
    return _rot_mats(degrees, 1.0) @ _flip_mats(hflip)


def inverse_matrices(degrees: torch.Tensor, hflip: torch.Tensor) -> torch.Tensor:
    """Sampling matrices of the inverse rotate(flip(x), -d): M = F @ R_{-d}."""
    return _flip_mats(hflip) @ _rot_mats(degrees, -1.0)


def _fill_arr(fill, b: int, c: int, device) -> torch.Tensor:
    """Scalar, (C,) or (B, C) fill -> (B, 1, 1, C) f32."""
    return cuda_warp.fill_table(fill, b, c, device).reshape(b, 1, 1, c)


def sample_affine(images: torch.Tensor, mats: torch.Tensor, fill=0.0) -> torch.Tensor:
    """Bilinear-resample a batch through per-image 2x2 centre-relative maps.

    images (B, H, W, C); mats (B, 2, 2) (output coord -> source coord);
    fill scalar, (C,) or (B, C). Returns (B, H, W, C) in images' dtype."""
    b, h, w, c = images.shape
    dev = images.device
    imgs = images.to(torch.float32).reshape(b, h * w, c)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev) - cy
    xs = torch.arange(w, dtype=torch.float32, device=dev) - cx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)                       # (H, W, 2) as (x, y)
    src = torch.einsum("bij,hwj->bhwi", mats.to(torch.float32), grid)
    sx = src[..., 0] + cx
    sy = src[..., 1] + cy
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = (sx - x0)[..., None], (sy - y0)[..., None]
    fill_arr = _fill_arr(fill, b, c, dev)

    def corner(xi, yi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(b, h * w, 1).expand(b, h * w, c)
        gathered = torch.gather(imgs, 1, idx).reshape(b, h, w, c)
        return torch.where(inside[..., None], gathered, fill_arr)

    out = (
        corner(x0, y0) * (1 - tx) * (1 - ty)
        + corner(x0 + 1, y0) * tx * (1 - ty)
        + corner(x0, y0 + 1) * (1 - tx) * ty
        + corner(x0 + 1, y0 + 1) * tx * ty
    )
    return out.to(images.dtype)


# ----------------------------- shear path -----------------------------


def _shear(v: torch.Tensor, lam: torch.Tensor, axis: int, fill: torch.Tensor) -> torch.Tensor:
    """1-D bilinear resample along ``axis`` (1 = y, 2 = x) with shift
    d = lam * (j - cj) per index j of the OTHER spatial axis:
    out[i] = in[i + d], ``fill`` outside the source. v (B, H, W, C);
    lam (B,); fill (B, 1, 1, C)."""
    b, h, w, c = v.shape
    n = v.shape[axis]
    m = v.shape[3 - axis]
    cj = (m - 1) / 2.0
    d = lam[:, None] * (torch.arange(m, dtype=torch.float32, device=v.device) - cj)
    k = torch.floor(d)
    frac = d - k
    src0 = torch.arange(n, device=v.device)[None, None, :] + k.to(torch.int64)[:, :, None]
    if axis == 1:  # (B, m, n) indexed [b, col, row] -> [b, row, col]
        src0 = src0.transpose(1, 2)
        frac_b = frac[:, None, :, None]
    else:
        frac_b = frac[:, :, None, None]
    src0 = src0[..., None]

    def tap(src):
        idx = src.clamp(0, n - 1).expand(b, h, w, c)
        valid = (src >= 0) & (src <= n - 1)
        return torch.where(valid, torch.gather(v, axis, idx), fill)

    return (1.0 - frac_b) * tap(src0) + frac_b * tap(src0 + 1)


def _rot90(v: torch.Tensor, sign: int) -> torch.Tensor:
    """Exact 90-degree rotation matching sample_affine(deg=sign*90)."""
    t = v.transpose(1, 2)
    return t.flip(1) if sign > 0 else t.flip(2)


def _shear_rotate(images: torch.Tensor, degrees: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Rotate by per-image ``degrees`` (|deg| <= 135): rot90 composition
    plus three Paeth shears."""
    b = images.shape[0]
    deg = degrees.to(torch.float32)
    n90 = torch.where(
        deg > 45.0,
        torch.ones_like(deg),
        torch.where(deg < -45.0, -torch.ones_like(deg), torch.zeros_like(deg)),
    )
    sel = n90.reshape(b, 1, 1, 1)
    v = torch.where(
        sel == 1, _rot90(images, 1), torch.where(sel == -1, _rot90(images, -1), images)
    )
    rad = torch.deg2rad(deg - 90.0 * n90)
    lam_x = -torch.tan(rad / 2.0)
    lam_y = torch.sin(rad)
    v = _shear(v, lam_x, axis=2, fill=fill)
    v = _shear(v, lam_y, axis=1, fill=fill)
    return _shear(v, lam_x, axis=2, fill=fill)


def _hflip_select(v: torch.Tensor, hflip: torch.Tensor) -> torch.Tensor:
    sel = hflip.reshape(v.shape[0], 1, 1, 1) > 0.5
    return torch.where(sel, v.flip(2), v)


# ----------------------------- dispatch -----------------------------


def _resolve_method(method: str, images: torch.Tensor) -> str:
    """'auto' -> the CUDA kernel for a CUDA tensor, the shear path for a
    CPU tensor. Non-square images route to the gather path: the rot90
    composition transposes the canvas, so only a square one keeps its
    shape."""
    if method not in METHODS:
        raise ValueError(f"warp method must be auto|cuda|shear|gather, got {method!r}")
    if images.shape[1] != images.shape[2] and method != "gather":
        return "gather"
    if method != "auto":
        return method
    return "cuda" if images.is_cuda else "shear"


def _rows(out: torch.Tensor, rows) -> torch.Tensor:
    return out if rows is None else out[:, rows[0]:rows[0] + rows[1]]


def augment(images, degrees, hflip, fill=0.0, method: str = "auto", rows=None):
    """Forward augmentation: rotate by ``degrees`` then horizontally flip;
    the output rows ``rows`` = (row0, R) alone when given."""
    method = _resolve_method(method, images)
    degrees = degrees.to(images.device)
    hflip = hflip.to(images.device)
    if method == "gather":
        return _rows(sample_affine(images, aug_matrices(degrees, hflip), fill), rows)
    if method == "cuda":
        return cuda_warp.warp_rotate_flip(images, degrees, hflip, fill, inverse=False, rows=rows)
    b, _, _, c = images.shape
    v = _shear_rotate(images.to(torch.float32), degrees, _fill_arr(fill, b, c, images.device))
    return _rows(_hflip_select(v, hflip).to(images.dtype), rows)


def invert(maps, degrees, hflip, fill=0.0, method: str = "auto", rows=None):
    """Inverse augmentation of predicted maps (un-flip, un-rotate); the
    output rows ``rows`` = (row0, R) alone when given."""
    method = _resolve_method(method, maps)
    degrees = degrees.to(maps.device)
    hflip = hflip.to(maps.device)
    if method == "gather":
        return _rows(sample_affine(maps, inverse_matrices(degrees, hflip), fill), rows)
    if method == "cuda":
        return cuda_warp.warp_rotate_flip(maps, degrees, hflip, fill, inverse=True, rows=rows)
    b, _, _, c = maps.shape
    v = _hflip_select(maps.to(torch.float32), hflip)
    v = _shear_rotate(v, -degrees, _fill_arr(fill, b, c, maps.device))
    return _rows(v.to(maps.dtype), rows)
