"""Segmentation metrics on (B, H, W, C) logits and (B, H, W) targets, and
per-case volume metrics.

The counterparts of ``aide_tpu.ops.metrics``. ``dice_fn`` returns the SUM
of per-image dice over the batch, with the empty-mask rule: both prediction
and target empty => 1.0, a non-empty prediction on an empty target => 0.0;
``iou_fn`` scores a both-empty image 1.0 too, and ``tp_tn_fp_fn`` sums
over the batch. The multiclass metrics take one-hot targets (B, H, W, C)
and the argmax of the logits, and average over the batch. ``dice3d``,
``iou3d`` and ``tp_tn_fp_fn_3d`` score whole volumes (union 0 => 1.0).
Only ``dice_fn`` is on the train steps' path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def dice_fn_nozero(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5):
    """(dice sum, count of images that are not both empty)."""
    dice, counted = _dice_vector(logits, targets, threshold)
    return dice.sum(), counted.sum()


def iou_fn(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Batch-summed thresholded IoU; a both-empty image scores 1.0."""
    pred = _binarize_fg(logits, threshold)
    n = pred.shape[0]
    iflat = pred.reshape(n, -1)
    tflat = _binarize_target(targets).reshape(n, -1)
    inter = (iflat * tflat).sum(dim=1)
    union = iflat.sum(dim=1) + tflat.sum(dim=1) - inter
    iou = torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1e-12))
    return iou.sum()


def _confusion(pred: torch.Tensor, t: torch.Tensor, dims=None):
    def total(x):
        return x.sum() if dims is None else x.sum(dim=dims)

    return total(pred * t), total((1 - pred) * (1 - t)), total(pred * (1 - t)), total((1 - pred) * t)


def tp_tn_fp_fn(logits: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5):
    """Confusion counts (tp, tn, fp, fn) summed over the batch."""
    return _confusion(_binarize_fg(logits, threshold), _binarize_target(targets))


def _argmax_flat(logits: torch.Tensor, targets_onehot: torch.Tensor):
    """(B, H*W, C) one-hot argmax prediction and f32 target."""
    c = targets_onehot.shape[-1]
    n = logits.shape[0]
    pred = F.one_hot(torch.argmax(logits, dim=-1), c).to(torch.float32)
    return pred.reshape(n, -1, c), targets_onehot.reshape(n, -1, c).to(torch.float32)


def multiclass_dice_fn(logits: torch.Tensor, targets_onehot: torch.Tensor) -> torch.Tensor:
    """Per-class Dice (C,) averaged over the batch; union 0 => 1.0."""
    iflat, tflat = _argmax_flat(logits, targets_onehot)
    inter = 2.0 * (iflat * tflat).sum(dim=1)
    union = iflat.sum(dim=1) + tflat.sum(dim=1)
    dice = torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1e-12))
    return dice.sum(dim=0) / iflat.shape[0]


def multiclass_iou_fn(logits: torch.Tensor, targets_onehot: torch.Tensor) -> torch.Tensor:
    """Per-class IoU (C,) averaged over the batch; union 0 => 1.0."""
    iflat, tflat = _argmax_flat(logits, targets_onehot)
    inter = (iflat * tflat).sum(dim=1)
    union = iflat.sum(dim=1) + tflat.sum(dim=1)
    iou = torch.where(union == 0, torch.ones_like(union),
                      inter / torch.clamp(union - inter, min=1e-12))
    return iou.sum(dim=0) / iflat.shape[0]


def multiclass_accuracy_fn(logits: torch.Tensor, targets_onehot: torch.Tensor) -> torch.Tensor:
    """Correctly classified pixels over the batch size."""
    iflat, tflat = _argmax_flat(logits, targets_onehot)
    return (iflat * tflat).sum() / iflat.shape[0]


def multiclass_tp_tn_fp_fn(logits: torch.Tensor, targets_onehot: torch.Tensor):
    """Per-class confusion counts, four (C,) tensors over the batch size."""
    iflat, tflat = _argmax_flat(logits, targets_onehot)
    n = iflat.shape[0]
    return tuple(x / n for x in _confusion(iflat, tflat, dims=(0, 1)))


def _volume(x: torch.Tensor) -> torch.Tensor:
    return (torch.as_tensor(x).reshape(-1) > 0).to(torch.float32)


def dice3d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Volume Dice 2I/(|P|+|T|), 1.0 when both are empty."""
    p, t = _volume(pred), _volume(target)
    inter = 2.0 * (p * t).sum()
    union = p.sum() + t.sum()
    return torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1e-12))


def iou3d(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Volume IoU, 1.0 when both are empty."""
    p, t = _volume(pred), _volume(target)
    inter = (p * t).sum()
    union = p.sum() + t.sum() - inter
    return torch.where(union == 0, torch.ones_like(union), inter / torch.clamp(union, min=1e-12))


def tp_tn_fp_fn_3d(pred: torch.Tensor, target: torch.Tensor):
    """Volume confusion counts (tp, tn, fp, fn)."""
    return _confusion(_volume(pred), _volume(target))
