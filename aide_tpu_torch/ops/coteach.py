"""Co-teaching loss library: the small-loss sample-exchange variants.

The counterpart of ``aide_tpu.ops.coteach``. These are library losses: the
train steps do not call them (the co-teaching step builds its exchange
inline in ``engine/steps.py``), so they are on no path of the card and have
no kernel. Selection counts are Python ints, rankings are stable sorts (as
``jnp.argsort``), and every loss is differentiable in the logits.

Logits are NHWC (B, H, W, C); targets are (B, H, W) integer or binary maps.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from aide_tpu_torch.ops import losses

Pair = Tuple[torch.Tensor, torch.Tensor]


def _per_image_ce_dice(logits, targets, weight: float) -> torch.Tensor:
    """weight * mean-pixel CE + per-image Dice: the ranking loss of every
    image-level variant."""
    ce = losses.cross_entropy_2d(logits, targets, reduction="none").mean(dim=(1, 2))
    return weight * ce + losses.dice_loss(logits, targets, reduction="none")


def _num_remember(forget_rate: float, n: int) -> int:
    k = int((1.0 - forget_rate) * n)
    if k < 1:
        raise ValueError(
            f"forget_rate={forget_rate} keeps {k} of {n} samples; "
            "at least one sample/patch/pixel must be remembered"
        )
    return k


def _order(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.argsort(x.detach(), dim=dim, stable=True)


def coteach_drop_image(logits1, logits2, targets, forget_rate: float, weight: float = 1.0) -> Pair:
    """Image-level small-loss exchange: each net's loss is its mean over the
    images the other net ranks lowest-loss."""
    k = _num_remember(forget_rate, logits1.shape[0])
    l1 = _per_image_ce_dice(logits1, targets, weight)
    l2 = _per_image_ce_dice(logits2, targets, weight)
    return l1[_order(l2)[:k]].mean(), l2[_order(l1)[:k]].mean()


def coteach_weight_image(logits1, logits2, targets, forget_rate: float, weight: float = 1.0,
                         drop_weight: float = 0.1) -> Pair:
    """The soft variant: the other net's dropped images keep ``drop_weight``."""
    n = logits1.shape[0]
    k = _num_remember(forget_rate, n)
    l1 = _per_image_ce_dice(logits1, targets, weight)
    l2 = _per_image_ce_dice(logits2, targets, weight)

    def side(lvec, order):
        loss = lvec[order[:k]].mean()
        if n - k > 0:
            loss = loss + drop_weight * lvec[order[k:]].mean()
        return loss

    return side(l1, _order(l2)), side(l2, _order(l1))


def coteach_drop_region_ce(logits1, logits2, targets, forget_rate: float, scale: float = 0.5) -> Pair:
    """Region-level exchange: logits and targets max-pooled into a grid of
    patches (ceil mode: a trailing partial window is a patch of its own),
    patch CE ranked per image, each net's loss its mean over the other's
    lowest-CE patches."""
    b, h, w, _ = logits1.shape
    kh, kw = h // int(h * scale), w // int(w * scale)
    pad_h, pad_w = (-h) % kh, (-w) % kw

    def pool(x):  # NHWC -> pooled NHWC, -inf past the high edges
        x = F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), value=-float("inf"))
        return F.max_pool2d(x, (kh, kw), stride=(kh, kw)).permute(0, 2, 3, 1)

    pt = pool(targets.to(torch.float32)[..., None])[..., 0].to(torch.int64)
    ce1 = losses.cross_entropy_2d(pool(logits1), pt, reduction="none").reshape(b, -1)
    ce2 = losses.cross_entropy_2d(pool(logits2), pt, reduction="none").reshape(b, -1)
    k = _num_remember(forget_rate, ce1.shape[1])
    loss1 = torch.gather(ce1, 1, _order(ce2, 1)[:, :k]).mean()
    loss2 = torch.gather(ce2, 1, _order(ce1, 1)[:, :k]).mean()
    return loss1, loss2


def _masked_smallest_mean(values: torch.Tensor, mask: torch.Tensor, remember_rate: float) -> torch.Tensor:
    """Mean of the lowest ``remember_rate`` share of ``values`` where ``mask``."""
    big = torch.finfo(torch.float32).max
    v = torch.where(mask > 0, values, torch.full_like(values, big))
    v_sorted = torch.sort(v).values
    k = torch.floor(remember_rate * (mask > 0).sum().to(torch.float32)).to(torch.int64)
    sel = (torch.arange(v.shape[0], device=v.device) < k).to(torch.float32)
    return (v_sorted * sel).sum() / torch.clamp(k.to(torch.float32), min=1.0)


def coteach_drop_image_drop_pixel(logits1, logits2, targets, forget_rate: float,
                                  weight: float = 1.0, pixel_weight: float = 0.25) -> Pair:
    """The image-level exchange plus, on the other net's dropped images, the
    lowest ``1 - forget_rate`` share of foreground pixels ranked by
    bidirectional KL + CE (each side counts its own share)."""
    n = logits1.shape[0]
    k = _num_remember(forget_rate, n)
    l1 = _per_image_ce_dice(logits1, targets, weight)
    l2 = _per_image_ce_dice(logits2, targets, weight)
    order1, order2 = _order(l1), _order(l2)
    loss1 = l1[order2[:k]].mean()
    loss2 = l2[order1[:k]].mean()
    remember_rate = 1.0 - forget_rate

    def pixel_side(sel, primary, secondary):
        if n - k == 0:
            return torch.zeros((), device=primary.device)
        a, t = primary[sel], targets[sel]
        kl = losses.kl_bidirectional(a, secondary[sel])
        ce = losses.cross_entropy_2d(a, t, reduction="none")
        tf = t.to(torch.float32)
        flat = ((kl + ce) * tf).reshape(-1)
        fg = tf.reshape(-1) * (flat > 0).to(torch.float32)
        return _masked_smallest_mean(flat, fg, remember_rate)

    loss1 = loss1 + pixel_weight * pixel_side(order2[k:], logits1, logits2)
    loss2 = loss2 + pixel_weight * pixel_side(order1[k:], logits2, logits1)
    return loss1, loss2


def _focal(logits, t):
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return (-t * (1 - probs[..., 1]) ** 2 * logp[..., 1]
            - (1 - t) * (1 - probs[..., 0]) ** 2 * logp[..., 0])


def _keep_pixels(joint, source, t, forget_rate: float) -> Pair:
    """Mean of ``source`` at each image's lowest ``1 - forget_rate`` share of
    ``joint``, and the share of the foreground those pixels keep."""
    k = _num_remember(forget_rate, joint.shape[1])
    order = _order(joint, 1)[:, :k]
    kept_t = torch.gather(t, 1, order)
    retention = kept_t.sum() / torch.clamp(t.sum(), min=1.0)
    return torch.gather(source, 1, order).mean(), retention


def pixel_coreg_focal(logits1, logits2, logits3, targets, forget_rate: float,
                      kd_weight: float) -> Pair:
    """Three-model pixel co-regularisation: nets 1 and 2 co-regularise by
    symmetric KL, the joint focal + KL map picks each image's kept pixels,
    and the loss is net 3's focal loss there. Returns (loss, foreground
    retention)."""
    b = targets.shape[0]
    t = targets.to(torch.float32)
    l1, l2, l3 = (_focal(x, t).reshape(b, -1) for x in (logits1, logits2, logits3))
    kl = losses.kl_bidirectional(logits1, logits2).reshape(b, -1)
    joint = (1.0 - kd_weight) * (l1 + l2 + l3) + kd_weight * kl
    return _keep_pixels(joint, l3, t.reshape(b, -1), forget_rate)


def pixel_coreg_focal_two_model(logits1, logits2, targets, forget_rate: float,
                                kd_weight: float) -> Pair:
    """Two-model pixel co-regularisation: the joint focal + symmetric-KL map
    keeps each image's lowest pixels, and the loss is its mean there.
    Returns (loss, foreground retention)."""
    b = targets.shape[0]
    t = targets.to(torch.float32)
    l1, l2 = (_focal(x, t).reshape(b, -1) for x in (logits1, logits2))
    kl = losses.kl_bidirectional(logits1, logits2).reshape(b, -1)
    joint = (1.0 - kd_weight) * (l1 + l2) + kd_weight * kl
    return _keep_pixels(joint, joint, t.reshape(b, -1), forget_rate)
