"""Test-time-augmentation pseudo-label machinery, on the device.

The counterpart of ``aide_tpu.ops.tta``: generate V augmented views, run
the nets on them, invert the augmentation on the predicted logits, average
the softmaxes, temperature-sharpen, and derive the confidence weightmap.
The V views are folded into the batch axis, so a net sees one (V*B) forward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aide_tpu_torch.ops import warp


def sample_view_params(
    gen: torch.Generator,
    num_views: int,
    batch: int,
    rotation_degree: float,
    hflip_prob: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-view, per-image rotation angles, uniform in ±rotation_degree,
    and flip flags, each an independent coin of probability hflip_prob:
    the distributions of the JAX package's draw, from ``gen``'s stream.
    Returns two (V, B) f32 tensors on ``gen``'s device."""
    u = torch.rand((num_views, batch), generator=gen, device=gen.device)
    degrees = -rotation_degree + 2.0 * rotation_degree * u
    coin = torch.rand((num_views, batch), generator=gen, device=gen.device)
    return degrees, (coin < hflip_prob).to(torch.float32)


def make_views(images, degrees, hflip, fill=0.0, method: str = "auto", rows=None):
    """(B, H, W, C) -> (V, B, H, W, C) augmented views via one batched warp.
    A (B, C) fill is tiled over the views. With ``rows`` = (row0, R), the
    views' rows [row0, row0 + R) alone: (V, B, R, W, C)."""
    v, b = degrees.shape
    flat = images.unsqueeze(0).expand((v,) + tuple(images.shape))
    flat = flat.reshape((v * b,) + tuple(images.shape[1:]))
    fill_flat = fill
    if torch.as_tensor(fill).ndim == 2:
        fill_flat = torch.as_tensor(fill).repeat(v, 1)
    out = warp.augment(
        flat, degrees.reshape(-1), hflip.reshape(-1), fill_flat, method=method, rows=rows
    )
    return out.reshape((v, b) + tuple(out.shape[1:]))


def invert_views(view_logits, degrees, hflip, method: str = "auto", rows=None):
    """Invert the augmentation on per-view logits (V, B, H, W, C), zero fill;
    with ``rows`` = (row0, R), the output rows [row0, row0 + R) alone."""
    v, b = degrees.shape
    flat = view_logits.reshape((v * b,) + tuple(view_logits.shape[2:]))
    out = warp.invert(flat, degrees.reshape(-1), hflip.reshape(-1), 0.0, method=method, rows=rows)
    return out.reshape((v, b) + tuple(out.shape[1:]))


def sharpen(probs: torch.Tensor, temperature: float, mode: str = "pow_t") -> torch.Tensor:
    """Temperature sharpening: probs**T ('pow_t') or probs**(1/T)
    ('pow_inv_t'), renormalized over the class axis."""
    if mode == "pow_t":
        p = torch.pow(probs, temperature)
    elif mode == "pow_inv_t":
        p = torch.pow(probs, 1.0 / temperature)
    else:
        raise ValueError(f"unknown sharpen mode {mode!r}")
    return p / torch.sum(p, dim=-1, keepdim=True)


def confidence_weightmap(pseudo_probs: torch.Tensor) -> torch.Tensor:
    """Confidence weight in [0, 1], (..., 1): 1 - 4*p0*p1 for two classes,
    1 - normalized entropy for more."""
    c = pseudo_probs.shape[-1]
    if c == 2:
        w = 1.0 - 4.0 * pseudo_probs[..., 0] * pseudo_probs[..., 1]
    else:
        p = torch.clamp(pseudo_probs, 1e-8, 1.0)
        entropy = -torch.sum(p * torch.log(p), dim=-1)
        w = 1.0 - entropy / torch.log(torch.tensor(float(c)))
    return w[..., None]


def ensemble_pseudo_labels(
    view_logits: torch.Tensor,
    degrees: torch.Tensor,
    hflip: torch.Tensor,
    temperature: float,
    sharpen_mode: str = "pow_t",
    method: str = "auto",
):
    """Invert views, average the f32 softmax, sharpen, weightmap.
    view_logits (V, B, H, W, C) -> pseudo (B, H, W, C), weightmap (B, H, W, 1)."""
    inv = invert_views(view_logits, degrees, hflip, method=method)
    probs = torch.softmax(inv.to(torch.float32), dim=-1)
    pseudo = sharpen(probs.mean(dim=0), temperature, sharpen_mode)
    return pseudo, confidence_weightmap(pseudo)
