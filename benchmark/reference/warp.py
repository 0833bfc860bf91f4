"""The TTA rotate/flip warp in plain PyTorch: a frozen copy of the function
that ``aide_tpu_torch/csrc/warp_rotate_flip.cu`` computes (its plain twin
``cuda_warp.warp_plain``). Rotation about the image centre is an exact
rot90 where |degrees| > 45, then three Paeth shears (along x by
-tan(theta/2), along y by sin(theta), along x again), each a 2-tap linear
resample with the fill outside the source; forward: rotate then flip the
output horizontally; inverse: flip the source, then rotate by -degrees.
"""

from __future__ import annotations

import torch


def coef_table(degrees: torch.Tensor, hflip: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(N,) degrees and flips -> (N, 4) [lam_x, lam_y, n90, flip]."""
    deg = degrees.to(torch.float32)
    if inverse:
        deg = -deg
    n90 = torch.where(deg > 45.0, torch.ones_like(deg),
                      torch.where(deg < -45.0, -torch.ones_like(deg), torch.zeros_like(deg)))
    rad = torch.deg2rad(deg - 90.0 * n90)
    flip = (hflip.to(torch.float32) > 0.5).to(torch.float32)
    return torch.stack([-torch.tan(rad / 2.0), torch.sin(rad), n90, flip], dim=1)


def warp(images: torch.Tensor, degrees: torch.Tensor, hflip: torch.Tensor, fill,
         inverse: bool) -> torch.Tensor:
    """(N, S, S, C) -> (N, S, S, C) f32; ``fill`` a scalar or (N, C)."""
    n, s, _, c = images.shape
    dev = images.device
    table = coef_table(degrees.to(dev), hflip.to(dev), inverse)
    fill_b = torch.as_tensor(fill, dtype=torch.float32, device=dev)
    fill_b = fill_b.reshape(1, 1, 1, 1) if fill_b.ndim == 0 else fill_b.reshape(n, 1, 1, c)
    flat = images.to(torch.float32).reshape(n * s * s, c)
    base = (torch.arange(n, device=dev) * (s * s)).reshape(n, 1, 1)
    cen = (s - 1) / 2.0
    lam_x = table[:, 0].reshape(n, 1, 1)
    lam_y = table[:, 1].reshape(n, 1, 1)
    n90 = table[:, 2].to(torch.int64).reshape(n, 1, 1)
    flip = (table[:, 3] > 0.5).reshape(n, 1, 1)
    ys = torch.arange(s, device=dev).reshape(1, s, 1).expand(n, s, s)
    xs = torch.arange(s, device=dev).reshape(1, 1, s).expand(n, s, s)
    if not inverse:
        xs = torch.where(flip, s - 1 - xs, xs)

    def inside(i):
        return (i >= 0) & (i <= s - 1)

    def split(lam, j):
        d = lam * (j.to(torch.float32) - cen)
        k = torch.floor(d)
        return k.to(torch.int64), (d - k)[..., None]

    def tap(valid, i, j):
        r = torch.where(n90 == 1, j, torch.where(n90 == -1, s - 1 - j, i))
        col = torch.where(n90 == 1, s - 1 - i, torch.where(n90 == -1, i, j))
        if inverse:
            col = torch.where(flip, s - 1 - col, col)
        src = flat[(base + r.clamp(0, s - 1) * s + col.clamp(0, s - 1)).reshape(-1)]
        return torch.where(valid[..., None], src.reshape(n, s, s, c), fill_b)

    def lerp(f, a, b):
        return (1.0 - f) * a + f * b

    k3, f3 = split(lam_x, ys)
    stage2 = []
    for t3 in (0, 1):
        x3 = xs + k3 + t3
        k2, f2 = split(lam_y, x3)
        stage1 = []
        for t2 in (0, 1):
            y2 = ys + k2 + t2
            k1, f1 = split(lam_x, y2)
            a, b = (tap(inside(x3 + k1 + t1), y2, x3 + k1 + t1) for t1 in (0, 1))
            stage1.append(torch.where(inside(y2)[..., None], lerp(f1, a, b), fill_b))
        stage2.append(torch.where(inside(x3)[..., None], lerp(f2, *stage1), fill_b))
    return lerp(f3, *stage2)
