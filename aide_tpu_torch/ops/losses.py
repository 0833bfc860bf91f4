"""Segmentation losses on (B, H, W, C) logits.

The counterparts of ``aide_tpu.ops.losses``: the ones the train steps use,
and the rest of the library (``dice_loss``, ``ce_dice_loss``,
``binary_cross_entropy_2d``, ``focal_loss``, ``kl_bidirectional``), which
no step calls.
Targets are integer maps (B, H, W) or one-hot maps (B, H, W, C).
Reductions: ``mean`` over images (Dice) / weighted mean over pixels (CE),
``sum``, or ``none`` (per-image vectors for Dice, per-pixel maps for CE).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _class_weights(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The (C,) f32 class weights on ``device``, built once per values and
    device: a step copies nothing from the host, so it waits for nothing
    and a CUDA graph can capture it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _as_class_indices(targets: torch.Tensor) -> torch.Tensor:
    """One-hot (B, H, W, C) -> indices (B, H, W); integer maps pass."""
    if targets.ndim == 4:
        return torch.argmax(targets, dim=-1)
    return targets


def _reduce_per_image(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy_2d(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weight: Optional[Sequence[float]] = None,
    reduction: str = "mean",
    ignore_index: int = 255,
) -> torch.Tensor:
    """Pixelwise cross entropy over the class axis; with ``class_weight``
    and ``reduction='mean'`` the weighted mean sum(w_t*ce)/sum(w_t) over
    non-ignored pixels."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    targets = _as_class_indices(targets).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ignored = targets == ignore_index
    safe_t = torch.where(ignored, torch.zeros_like(targets), targets)
    nll = -torch.gather(logp, -1, safe_t[..., None])[..., 0]
    if class_weight is not None:
        cw = _class_weights(tuple(float(w) for w in class_weight), logp.device)
        w = cw[safe_t]
    else:
        w = torch.ones_like(nll)
    w = w * (~ignored).to(nll.dtype)
    loss = nll * w
    if reduction == "mean":
        return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss


def soft_dice_from_probs(
    fg_probs: torch.Tensor,
    targets: torch.Tensor,
    smooth: float = 1.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Binary soft Dice on probabilities, per image."""
    n = fg_probs.shape[0]
    iflat = fg_probs.reshape(n, -1).to(torch.float32)
    tflat = targets.reshape(n, -1).to(torch.float32)
    inter = (iflat * tflat).sum(dim=1)
    loss = 1.0 - (2.0 * inter + smooth) / (iflat.sum(dim=1) + tflat.sum(dim=1) + smooth)
    return _reduce_per_image(loss, reduction)


def dice_loss(
    logits_or_probs: torch.Tensor,
    targets: torch.Tensor,
    smooth: float = 1.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Binary soft Dice: a 4-D input is softmaxed and its foreground
    channel taken, a 3-D input is used as probabilities."""
    if logits_or_probs.ndim == 4:
        fg = torch.softmax(logits_or_probs.to(torch.float32), dim=-1)[..., 1]
    else:
        fg = logits_or_probs
    return soft_dice_from_probs(fg, targets, smooth, reduction)


def multiclass_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    class_weight: Optional[Sequence[float]] = None,
    smooth: float = 1.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax, then per-class binary Dice summed over classes (one-hot
    targets) or the foreground-channel Dice (integer targets)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    if targets.ndim == 4:
        total = 0.0
        for i in range(targets.shape[-1]):
            d = soft_dice_from_probs(probs[..., i], targets[..., i], smooth, reduction)
            if class_weight is not None:
                d = d * class_weight[i]
            total = total + d
        return total
    return soft_dice_from_probs(probs[..., 1], targets, smooth, reduction)


def multiclass_mse_loss(
    logits: torch.Tensor, target_probs: torch.Tensor, reduction: str = "mean"
) -> torch.Tensor:
    """Softmax-MSE consistency loss."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    sq = (probs - target_probs.to(torch.float32)) ** 2
    return _reduce_per_image(sq, reduction)


def cem_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    cedice_weight: Sequence[float] = (1.0, 1.0),
    ceclass_weight: Optional[Sequence[float]] = None,
    diceclass_weight: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """CE + multiclass Dice, scalar."""
    ce = cross_entropy_2d(logits, targets, ceclass_weight, reduction="mean")
    dc = multiclass_dice_loss(logits, targets, diceclass_weight, reduction="mean")
    return ce * cedice_weight[0] + dc * cedice_weight[1]


def cem_dice_loss_image(
    logits: torch.Tensor,
    targets: torch.Tensor,
    cedice_weight: Sequence[float] = (1.0, 1.0),
    ceclass_weight: Optional[Sequence[float]] = None,
    diceclass_weight: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Per-image CE + Dice loss vector (B,): the small-loss ranking signal."""
    ce = cross_entropy_2d(logits, targets, ceclass_weight, reduction="none")
    ce = ce.mean(dim=(1, 2))
    dc = multiclass_dice_loss(logits, targets, diceclass_weight, reduction="none")
    return ce * cedice_weight[0] + dc * cedice_weight[1]


def ce_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    cedice_weight: Sequence[float] = (1.0, 1.0),
    class_weight: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """CE + binary Dice, scalar."""
    ce = cross_entropy_2d(logits, targets, class_weight, reduction="mean")
    dc = dice_loss(logits, targets, reduction="mean")
    return ce * cedice_weight[0] + dc * cedice_weight[1]


def binary_cross_entropy_2d(
    logits: torch.Tensor, targets: torch.Tensor, reduction: str = "none"
) -> torch.Tensor:
    """Binary CE over the two-channel softmax, per pixel
    -(1-t)*logp0 - t*logp1; ``mean`` and ``sum`` reduce over everything."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    t = targets.to(torch.float32)
    loss = -(1.0 - t) * logp[..., 0] - t * logp[..., 1]
    return _reduce_per_image(loss, reduction)


def focal_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    weight1: float = 1.0,
    weight2: float = 1.0,
    beta: float = 2.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Binary focal loss with the reference's cross-class modulation: the
    background log term is scaled by the foreground probability to the
    ``beta`` and the foreground one by the background probability."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    t = targets.to(torch.float32)
    loss = (
        -weight1 * torch.pow(probs[..., 1], beta) * logp[..., 0] * (1.0 - t)
        - weight2 * torch.pow(probs[..., 0], beta) * logp[..., 1] * t
    )
    return _reduce_per_image(loss, reduction)


def kl_bidirectional(logits1: torch.Tensor, logits2: torch.Tensor) -> torch.Tensor:
    """Symmetric KL between two nets' softmaxes, summed over classes, per
    pixel (B, H, W); in log space."""
    lp1 = torch.log_softmax(logits1.to(torch.float32), dim=-1)
    lp2 = torch.log_softmax(logits2.to(torch.float32), dim=-1)
    p1, p2 = lp1.exp(), lp2.exp()
    return (p1 * (lp1 - lp2)).sum(dim=-1) + (p2 * (lp2 - lp1)).sum(dim=-1)
