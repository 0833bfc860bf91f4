"""Thresholded Dice on (B, H, W, C) logits and (B, H, W) targets.

The counterparts of ``aide_tpu.ops.metrics._binarize_fg``,
``_binarize_target``, ``_dice_vector`` and ``dice_fn``. ``dice_fn`` returns
the SUM of per-image dice over the batch, with the empty-mask rule: both
prediction and target empty => 1.0, a non-empty prediction on an empty
target => 0.0.
"""

from __future__ import annotations

import torch


def _binarize_fg(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Foreground mask: softmax fg prob >= threshold for binary heads,
    argmax > 0 for C > 2."""
    if logits.shape[-1] > 2:
        return (torch.argmax(logits, dim=-1) > 0).to(torch.float32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)[..., 1]
    return (probs >= threshold).to(torch.float32)


def _binarize_target(targets: torch.Tensor) -> torch.Tensor:
    return (targets > 0).to(torch.float32)


def _dice_vector(logits: torch.Tensor, targets: torch.Tensor, threshold: float):
    """Per-image thresholded Dice (B,) and the not-trivially-empty flag (B,)."""
    pred = _binarize_fg(logits, threshold)
    n = pred.shape[0]
    iflat = pred.reshape(n, -1)
    tflat = _binarize_target(targets).reshape(n, -1)
    inter = (iflat * tflat).sum(dim=1)
    isum = iflat.sum(dim=1)
    tsum = tflat.sum(dim=1)
    one, zero = torch.ones_like(isum), torch.zeros_like(isum)
    dice = torch.where(
        tsum == 0,
        torch.where(isum == 0, one, zero),
        2.0 * inter / torch.clamp(isum + tsum, min=1e-12),
    )
    counted = torch.where((tsum == 0) & (isum == 0), 0, 1)
    return dice, counted


def dice_fn(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Batch-summed thresholded Dice."""
    dice, _ = _dice_vector(logits, targets, threshold)
    return dice.sum()
