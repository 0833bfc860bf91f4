"""Learning-rate schedules and the optimizers.

The counterpart of ``aide_tpu.ops.schedules``: epoch-level StepLR / PolyLR
as functions of the optimizer step count (the rate changes once per
epoch), the co-teaching consistency ramp, and ``make_optimizer``, which
builds every optimizer option of the JAX package with optax's semantics:
``amsgrad_adam`` (``optax.amsgrad``), ``adam`` (``optax.adam``) and ``sgd``
(``optax.sgd`` with momentum 0.9), each behind the optional
``grad_clip_norm`` (``optax.clip_by_global_norm``) and ``weight_decay``
(``optax.add_decayed_weights``, coupled L2 added to the gradient before the
optimizer, not AdamW), in optax's chain order: clip, decay, optimizer.

The optimizers are written out rather than taken from ``torch.optim``:
``torch.optim.Adam(amsgrad=True)`` takes its max over the raw second
moment, ``torch.optim.SGD`` dampens differently, and
``clip_grad_norm_`` adds 1e-6 to the norm. Each keeps its state as named
tensors per parameter (``MOMENTS``: mu/nu/nu_max, mu/nu or trace), made
when it is built, and one step count, which is what the exact-resume file
(``engine.checkpoint``) stores.

A step's scalars that change with the count (``hyper``: -lr(count) and
AMSGrad's and Adam's bias corrections) are computed on the host; ``step``
computes them itself, or takes them as ``given``: 0-dim tensors on the
parameters' device with the same f32 values, which a replayed CUDA graph
reads as inputs (``engine.graphs``). Both give the same update bit for
bit.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from aide_tpu_torch.core import mesh
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


class OptaxOptimizer(torch.optim.Optimizer):
    """An optax chain over torch parameters: global-norm clipping, then the
    decayed weights, then the optimizer's direction (``_direction``), then
    ``-lr(count)`` times it added to the parameters. ``schedule`` maps the
    step count before the update (0 at the first step) to the rate.

    One optimizer over the union of both nets' parameters is the JAX
    package's one transform over the stacked pair: its moments are
    elementwise, and its clipping norm is one norm over both nets'
    gradients, as JAX's over the stacked pytree. On a net axis each rank's
    optimizer holds its own net (``pair``): the moments need nothing else,
    and the clipping norm takes the partner's per-tensor norms through
    ``mesh.pair_exchange``, so it is the pair's norm, bit for bit the one
    process's."""

    NAME = ""
    MOMENTS: Tuple[str, ...] = ()

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        schedule: Callable[[int], float],
        grad_clip_norm: Optional[float] = None,
        weight_decay: float = 0.0,
        pair: bool = False,
    ):
        super().__init__(params, {})
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay
        self.pair = pair
        self.count = 0
        # the next step's ``hyper()`` as the caller gives it (a (K,) tensor
        # or K 0-dim ones); the step takes it and leaves None
        self.given = None
        for p in self.params():
            for m in self.MOMENTS:
                self.state[p][m] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.param_groups for p in group["params"]]

    def moments(self, name: str, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
        return [self.state[p][name] for p in params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: unchanged below the norm, else
        g / norm * max_norm (no epsilon), decided on the device. With
        ``pair`` the norm spans both nets' tensors, in net order."""
        norms = torch.stack(torch._foreach_norm(grads))
        if self.pair:
            norms = mesh.pair_exchange(norms)[0].reshape(-1)
        norm = torch.linalg.vector_norm(norms)
        keep = norm < self.grad_clip_norm
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.grad_clip_norm))
        out = torch._foreach_div(grads, div)
        torch._foreach_mul_(out, mul)
        return out

    def _direction(self, params, grads, *corrections) -> List[torch.Tensor]:
        raise NotImplementedError

    def _corrections(self, t: int) -> Tuple[float, ...]:
        """The direction's scalars at step t (1 at the first step)."""
        return ()

    def hyper(self) -> Tuple[float, ...]:
        """The next step's scalars from the step count: -lr(count), then
        the direction's (``_corrections(count + 1)``)."""
        return (-self.schedule(self.count),) + self._corrections(self.count + 1)

    @torch.no_grad()
    def step(self, closure=None):
        """One update, with the scalars ``given`` or else ``hyper()``'s."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        params = [p for p in self.params() if p.grad is not None]
        hyper, self.given = self.given, None
        neg_lr, *corrections = self.hyper() if hyper is None else hyper
        self.count += 1
        if not params:
            return None
        grads = [p.grad for p in params]
        if self.grad_clip_norm:
            grads = self._clip(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        upd = self._direction(params, grads, *corrections)
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(params, upd)
        return None


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay**t in f32 as optax computes it: decay**count on an int32
    count is an f32 power (powf, NumPy's scalar float32 power), not t
    multiplications, which part from it by an ulp of decay**t (2e-5 of
    1 - 0.999**3)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


class AMSGrad(OptaxOptimizer):
    """AMSGrad as ``optax.amsgrad`` computes it.

    mu = b1*mu + (1-b1)*g;  nu = b2*nu + (1-b2)*g^2;
    nu_max = max(nu_max, nu / (1 - b2^t));
    p -= lr(t-1) * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps).

    The max runs over the bias-corrected second moment, where
    ``torch.optim.Adam(amsgrad=True)`` takes it over the raw one; the two
    agree at t = 1 and part from t = 2."""

    NAME = "amsgrad_adam"
    MOMENTS = ("mu", "nu", "nu_max")
    b1, b2, eps = 0.9, 0.999, 1e-8

    def _second_moment(self, nu, params, bc2):
        nu_max = self.moments("nu_max", params)
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
        return nu_max

    def _corrections(self, t):
        return _bias_correction(self.b1, t), _bias_correction(self.b2, t)

    def _direction(self, params, grads, bc1, bc2):
        mu, nu = self.moments("mu", params), self.moments("nu", params)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(self._second_moment(nu, params, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        return upd


class Adam(AMSGrad):
    """``optax.adam``: AMSGrad's moments without the running max,
    p -= lr(t-1) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), eps
    outside the root (optax's eps_root is 0)."""

    NAME = "adam"
    MOMENTS = ("mu", "nu")

    def _second_moment(self, nu, params, bc2):
        return torch._foreach_div(nu, bc2)


class SGD(OptaxOptimizer):
    """``optax.sgd(momentum=0.9)``: optax.trace, t = g + 0.9*t (no
    dampening, no Nesterov), then p -= lr(t-1) * t."""

    NAME = "sgd"
    MOMENTS = ("trace",)
    momentum = 0.9

    def _direction(self, params, grads):
        trace = self.moments("trace", params)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        return torch._foreach_mul(trace, 1.0)  # a copy: step() scales it in place


OPTIMIZERS = {cls.NAME: cls for cls in (AMSGrad, Adam, SGD)}


def make_optimizer(params, cfg: OptimConfig, steps_per_epoch: int, num_epochs: int,
                   pair: bool = False) -> OptaxOptimizer:
    """The optimizer of ``cfg`` over ``params``: ``cfg.optimizer`` behind
    the optional clipping and weight decay; ``pair`` for one net of the
    co-teaching pair on a rank of a net axis (``OptaxOptimizer``)."""
    if cfg.optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return OPTIMIZERS[cfg.optimizer](
        params, make_lr_schedule(cfg, steps_per_epoch, num_epochs),
        grad_clip_norm=cfg.grad_clip_norm, weight_decay=cfg.weight_decay, pair=pair,
    )
