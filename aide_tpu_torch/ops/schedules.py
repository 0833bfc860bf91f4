"""Learning-rate schedules and the AMSGrad optimizer.

The counterpart of ``aide_tpu.ops.schedules``: epoch-level StepLR / PolyLR
as functions of the optimizer step count (the rate changes once per
epoch), the co-teaching consistency ramp, and ``make_optimizer`` for
``amsgrad_adam`` with optax's semantics.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from aide_tpu_torch.core.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int, num_epochs: int) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer step count."""
    spe = max(1, steps_per_epoch)
    if cfg.lr_policy == "StepLR":
        def schedule(count: int) -> float:
            return cfg.lr * (cfg.step_gamma ** ((count // spe) // cfg.step_size))
    elif cfg.lr_policy == "PolyLR":
        def schedule(count: int) -> float:
            # clamped, so the rate decays to 0 and stays there
            frac = max(0.0, 1.0 - (count // spe) / float(num_epochs))
            return cfg.lr * (frac ** cfg.poly_power)
    elif cfg.lr_policy in ("None", "none", ""):
        def schedule(count: int) -> float:
            return cfg.lr
    else:
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r}")
    return schedule


def rate_schedule(epoch: int, warmup_epochs: int) -> float:
    """Co-teaching consistency ramp: min((e/warmup)^2, 1)."""
    if warmup_epochs <= 0:
        return 1.0
    return min((float(epoch) / float(warmup_epochs)) ** 2, 1.0)


class AMSGrad(torch.optim.Optimizer):
    """AMSGrad as ``optax.amsgrad`` computes it.

    mu = b1*mu + (1-b1)*g;  nu = b2*nu + (1-b2)*g^2;
    nu_max = max(nu_max, nu / (1 - b2^t));
    p -= lr(t-1) * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps).

    The max runs over the bias-corrected second moment, where
    ``torch.optim.Adam(amsgrad=True)`` takes it over the raw one; the two
    agree at t = 1 and part from t = 2. ``schedule`` maps the step count
    before the update (0 at the first step) to the learning rate."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AMSGrad.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        t = self.count
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["nu_max"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            nu_max = [self.state[p]["nu_max"] for p in params]
            # bias corrections in f32, as optax's decay**count on an int32 count
            bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            nu_hat = torch._foreach_div(nu, bc2)
            torch._foreach_maximum_(nu_max, nu_hat)
            denom = torch._foreach_sqrt(nu_max)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
        return None


def make_optimizer(params, cfg: OptimConfig, steps_per_epoch: int, num_epochs: int) -> AMSGrad:
    """The optimizer of ``cfg`` over ``params``; the port has amsgrad_adam
    without clipping or weight decay."""
    if cfg.optimizer != "amsgrad_adam":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (amsgrad_adam is)"
        )
    if cfg.grad_clip_norm or cfg.weight_decay:
        raise NotImplementedError(
            "grad_clip_norm and weight_decay are not ported yet"
        )
    return AMSGrad(params, make_lr_schedule(cfg, steps_per_epoch, num_epochs))
