"""The port's AMSGrad and schedules against optax / aide_tpu.ops.schedules.

AMSGrad runs several updates on a fixed sequence of gradients (rtol 1e-6):
the max over the bias-corrected second moment only shows from the second
update on, where torch.optim.Adam(amsgrad=True) parts from optax.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aide_tpu.core.config import OptimConfig as JOptimConfig
from aide_tpu.ops import schedules as jsched

from aide_tpu_torch.core.config import OptimConfig
from aide_tpu_torch.ops import schedules

SHAPES = [(3, 4), (5,), (2, 3, 3, 2)]


def _grad_sequence(n_steps, seed=0):
    """Gradients that shrink after the first steps, so nu_max holds an old
    maximum and the AMSGrad variants disagree."""
    rng = np.random.default_rng(seed)
    scale = [1.0, 3.0, 0.2, 0.05, 1.5, 0.01][:n_steps]
    return [[(s * rng.normal(size=sh)).astype(np.float32) for sh in SHAPES] for s in scale]


def _run_optax(params0, grads, schedule):
    tx = optax.amsgrad(learning_rate=schedule)
    params = [jnp.asarray(p) for p in params0]
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        out.append([np.asarray(p) for p in params])
    return out


def _run_port(params0, grads, schedule, opt_cls=None):
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = opt_cls(params) if opt_cls else schedules.AMSGrad(params, schedule)
    out = []
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        out.append([p.detach().numpy().copy() for p in params])
    return out


@pytest.fixture
def params0():
    rng = np.random.default_rng(42)
    return [rng.normal(size=sh).astype(np.float32) for sh in SHAPES]


@pytest.mark.parametrize("policy", ["StepLR", "None"])
def test_amsgrad_matches_optax(params0, policy):
    cfg = OptimConfig(lr=1e-2, lr_policy=policy, step_size=1, step_gamma=0.5)
    jcfg = JOptimConfig(lr=1e-2, lr_policy=policy, step_size=1, step_gamma=0.5)
    grads = _grad_sequence(6)
    ref = _run_optax(params0, grads, jsched.make_lr_schedule(jcfg, 2, 10))
    out = _run_port(params0, grads, schedules.make_lr_schedule(cfg, 2, 10))
    for step, (r, o) in enumerate(zip(ref, out)):
        for a, b in zip(o, r):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"step {step}")


def test_torch_adam_amsgrad_differs_from_optax(params0):
    """The trap the port's AMSGrad avoids: torch's variant agrees with optax
    at the first update and not after."""
    grads = _grad_sequence(4)
    ref = _run_optax(params0, grads, 1e-2)
    torch_out = _run_port(params0, grads, None,
                          lambda ps: torch.optim.Adam(ps, lr=1e-2, amsgrad=True, eps=1e-8))
    np.testing.assert_allclose(torch_out[0][0], ref[0][0], rtol=1e-6, atol=1e-7)
    assert max(np.abs(a - b).max() for a, b in zip(torch_out[3], ref[3])) > 1e-4


def test_make_optimizer_rejects_unported():
    params = [torch.nn.Parameter(torch.zeros(2))]
    for cfg in (OptimConfig(optimizer="sgd"), OptimConfig(weight_decay=1e-4),
                OptimConfig(grad_clip_norm=1.0)):
        with pytest.raises(NotImplementedError):
            schedules.make_optimizer(params, cfg, 4, 10)
    assert isinstance(schedules.make_optimizer(params, OptimConfig(), 4, 10), schedules.AMSGrad)


@pytest.mark.parametrize("policy,spe,epochs", [("StepLR", 3, 100), ("StepLR", 1, 10),
                                                ("PolyLR", 4, 10), ("None", 5, 10)])
def test_lr_schedule_over_step_counts(policy, spe, epochs):
    kw = dict(lr=1e-3, lr_policy=policy, step_size=2, step_gamma=0.5, poly_power=0.9)
    ref = jsched.make_lr_schedule(JOptimConfig(**kw), spe, epochs)
    sched = schedules.make_lr_schedule(OptimConfig(**kw), spe, epochs)
    counts = list(range(0, spe * (epochs + 3), max(1, spe // 2)))
    got = [sched(c) for c in counts]
    want = [float(ref(jnp.asarray(c, jnp.int32))) for c in counts]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the rate changes only at epoch boundaries
    assert all(sched(e * spe) == sched(e * spe + spe - 1) for e in range(epochs))


def test_unknown_lr_policy_raises():
    with pytest.raises(ValueError):
        schedules.make_lr_schedule(OptimConfig(lr_policy="cosine"), 4, 10)


@pytest.mark.parametrize("warmup", [0, 1, 5, 20])
def test_rate_schedule(warmup):
    for epoch in range(0, 30, 3):
        assert schedules.rate_schedule(epoch, warmup) == jsched.rate_schedule(epoch, warmup)
