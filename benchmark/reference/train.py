"""The train steps in plain float32 PyTorch, and the TTA view draws.

``coteach_step`` is AIDE's dual-network cross co-teaching step:
  1. V views of each image (rotation, flip; ``reference.warp``), both
     nets' forwards on them in train-mode BatchNorm, the views' logits
     warped back, the softmax averaged over the views and sharpened
     (p^T, renormalised), and the confidence map 1 - 4*p0*p1;
  2. each net's main forward and its per-image CE + soft foreground Dice
     against the OTHER net's working labels;
  3. net k's loss over the rows the other net ranks lowest (its clean
     share), plus (1 - rate) times its mean over the rest, plus
     10 * rate * the confidence-weighted softmax-MSE to the other net's
     pseudo-labels on the rest;
  4. one backward of the sum, one AMSGrad update (optax's form).
``supervised_step`` is the comparison trainer's: CE + soft foreground Dice
over the batch, one backward, one AMSGrad update.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import warp


def derive_seed(*parts: int) -> int:
    """A 63-bit seed mixed from (seed, epoch, step) by NumPy's SeedSequence:
    the port's view-draw stream (``core/prng.py``)."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def view_params(device, seed: int, epoch: int, step: int, views: int, batch: int,
                degree: float, hflip_prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, B) rotation angles, uniform in +-degree, and flip flags of one
    train step, drawn from a generator on ``device`` as the trainer draws
    them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, epoch, step))
    u = torch.rand((views, batch), generator=gen, device=device)
    coin = torch.rand((views, batch), generator=gen, device=device)
    return -degree + 2.0 * degree * u, (coin < hflip_prob).to(torch.float32)


def shuffle_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The train slices' order in ``epoch`` (the trainer's shuffle, shuffle
    seed 0)."""
    order = np.arange(n)
    np.random.default_rng(seed * 100003 + epoch).shuffle(order)
    return order


class AMSGrad:
    """optax.amsgrad: mu = b1*mu + (1-b1)*g; nu = b2*nu + (1-b2)*g^2;
    nu_max = max(nu_max, nu / (1 - b2^t));
    p -= lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, mu, nu, nm in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            torch.maximum(nm, nu / bc2, out=nm)
            p.sub_(self.lr * (mu / bc1) / (nm.sqrt() + self.eps))


def image_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B,) per-image pixel-mean cross entropy + soft foreground Dice
    (smooth 1) of (B, H, W, 2) logits against (B, H, W) labels."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0].mean(dim=(1, 2))
    p = logp.exp()[..., 1].reshape(len(target), -1)
    t = target.reshape(len(target), -1).float()
    dice = 1.0 - (2.0 * (p * t).sum(1) + 1.0) / (p.sum(1) + t.sum(1) + 1.0)
    return ce + dice


def pseudo_labels(nets, images, fills, degrees, hflip, temperature: float = 1.0):
    """(n, B, H, W, C) sharpened view averages of the nets and their
    (n, B, H, W, 1) confidence maps."""
    v, b = degrees.shape
    with torch.no_grad():
        views = []
        for img, fill in zip(images, fills):
            flat = img.unsqueeze(0).expand((v,) + tuple(img.shape)).reshape((v * b,) + img.shape[1:])
            views.append(warp.warp(flat, degrees.reshape(-1), hflip.reshape(-1),
                                   fill.repeat(v, 1), inverse=False))
        logits = torch.cat([net(*views) for net in nets])
        n = len(nets)
        inv = warp.warp(logits, torch.cat([degrees] * n).reshape(-1),
                        torch.cat([hflip] * n).reshape(-1), 0.0, inverse=True)
        probs = torch.softmax(inv, dim=-1)
        avg = probs.reshape((n, v, b) + tuple(probs.shape[1:])).mean(dim=1)
        p = avg ** temperature
        pseudo = p / p.sum(dim=-1, keepdim=True)
        wmap = 1.0 - 4.0 * pseudo[..., 0] * pseudo[..., 1]
    return pseudo, wmap[..., None]


def _side(pre, out, order_other, pseudo_other, wmap_other, rate, clean_fraction,
          consistency_weight):
    b = pre.shape[0]
    k = max(1, min(b - 1, int(round(clean_fraction * b))))
    seg = pre[order_other[:k]].mean()
    if k == b:
        return seg
    rest = order_other[k:]
    seg = seg + (1.0 - rate) * pre[rest].mean()
    mse = (torch.softmax(out.float(), dim=-1) - pseudo_other) ** 2
    cons = (wmap_other * mse).mean(dim=(1, 2, 3))[rest].mean()
    return seg + consistency_weight * rate * cons


def coteach_step(nets, opt: AMSGrad, batch: Dict, degrees, hflip, rate: float,
                 clean_fraction: float = 0.5, consistency_weight: float = 10.0
                 ) -> Tuple[List[float], List[torch.Tensor]]:
    """One co-teaching step on ``batch`` (``reference.data.batch``, with the
    same labels for both nets); returns ([loss1, loss2], the gradients in
    ``opt``'s parameter order) and updates the nets."""
    images, fills, t = batch["images"], batch["fills"], batch["target"]
    for net in nets:
        net.train()
    pseudo, wmap = pseudo_labels(nets, images, fills, degrees, hflip)
    out = [net(*images) for net in nets]
    pre = [image_loss(o, t) for o in out]
    order = [torch.argsort(p.detach(), stable=True) for p in pre]
    loss = [_side(pre[k], out[k], order[1 - k], pseudo[1 - k], wmap[1 - k], rate,
                  clean_fraction, consistency_weight) for k in (0, 1)]
    grads = torch.autograd.grad(loss[0] + loss[1], opt.params)
    opt.step(grads)
    return [float(x.detach()) for x in loss], list(grads)


def supervised_step(nets, opt: AMSGrad, batch: Dict) -> Tuple[List[float], List[torch.Tensor]]:
    """One supervised step: batch-mean CE + soft foreground Dice."""
    (net,) = nets
    net.train()
    logits = net(*batch["images"])
    t = batch["target"]
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, t[..., None]).mean()
    p = logp.exp()[..., 1].reshape(len(t), -1)
    tf = t.reshape(len(t), -1).float()
    dice = (1.0 - (2.0 * (p * tf).sum(1) + 1.0) / (p.sum(1) + tf.sum(1) + 1.0)).mean()
    loss = ce + dice
    grads = torch.autograd.grad(loss, opt.params)
    opt.step(grads)
    return [float(loss.detach())], list(grads)
