"""The port's optimizers and schedules against optax / aide_tpu.ops.schedules.

Each optimizer runs several updates on a fixed sequence of gradients,
against the chain that ``aide_tpu.ops.schedules.make_optimizer`` builds
(rtol 1e-6, atol 1e-7 on the parameters and on every moment, the step
counts equal): AMSGrad's max over the bias-corrected second moment only
shows from the second update on, where torch.optim.Adam(amsgrad=True)
parts from optax. Every optimizer option runs with and without global-norm
clipping at 1.0 (the sequence's norms lie above and below it) and weight
decay 1e-4, and a dual case holds one clipping norm over both nets.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from aide_tpu.core.config import OptimConfig as JOptimConfig
from aide_tpu.ops import schedules as jsched

from aide_tpu_torch.core.config import OptimConfig
from aide_tpu_torch.ops import schedules


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _optax_moments(state, cfg):
    """{moment: [leaves]} and the counts of the optimizer's own state in
    the chain that make_optimizer builds (the layouts of
    engine/checkpoint.py)."""
    sd = serialization.to_state_dict(state)
    depth = bool(cfg.grad_clip_norm) + bool(cfg.weight_decay)
    inner = sd[str(depth)] if depth else sd
    moments = {k: [np.asarray(v[str(i)]) for i in range(len(v))]
               for k, v in inner["0"].items() if k != "count"}
    counts = [int(inner["1"]["count"])] + ([int(inner["0"]["count"])] if "count" in inner["0"] else [])
    return moments, counts


def _run_chain(cfg, params0, grads, spe=2):
    """The JAX chain of ``cfg`` and the port's optimizer over the same
    gradient sequence: per step, (params, moments, counts) of each."""
    jcfg = JOptimConfig(**vars(cfg))
    tx = jsched.make_optimizer(jcfg, spe, 10)
    jp = [jnp.asarray(p) for p in params0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params0]
    opt = schedules.make_optimizer(params, cfg, spe, 10)
    out = []
    for g in grads:
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        jm, jc = _optax_moments(state, jcfg)
        tm = {k: [opt.state[p][k].numpy().copy() for p in params] for k in opt.MOMENTS}
        out.append(dict(jax=([np.asarray(p) for p in jp], jm, jc),
                        port=([p.detach().numpy().copy() for p in params], tm, opt.count)))
    return out


def _assert_steps_match(steps):
    for i, s in enumerate(steps):
        (jp, jm, jc), (tp, tm, count) = s["jax"], s["port"]
        assert jc == [count] * len(jc) == [i + 1] * len(jc)
        assert set(tm) == set(jm)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"params, step {i}")
        for k in jm:
            for a, b in zip(tm[k], jm[k]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"{k}, step {i}")


@pytest.mark.parametrize("decay", [0.0, 1e-4])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", ["amsgrad_adam", "adam", "sgd"])
def test_optimizer_matches_optax(params0, name, clip, decay):
    """Every optimizer option behind clipping and decay: the parameters,
    the moments and the counts of each of 6 updates, as optax gives them."""
    cfg = OptimConfig(lr=1e-2, optimizer=name, grad_clip_norm=clip, weight_decay=decay,
                      step_size=1, step_gamma=0.5)
    grads = _grad_sequence(6)
    norms = [np.sqrt(sum(float((x * x).sum()) for x in g)) for g in grads]
    assert min(norms) < 1.0 < max(norms)  # clipping acts on some steps only
    steps = _run_chain(cfg, params0, grads)
    _assert_steps_match(steps)
    opt = schedules.make_optimizer([torch.nn.Parameter(torch.zeros(2))], cfg, 2, 10)
    assert type(opt) is schedules.OPTIMIZERS[name]
    if decay:
        # the decay shows in the moments beyond the tolerance
        plain = _run_chain(OptimConfig(**dict(vars(cfg), weight_decay=0.0)), params0, grads)
        k = schedules.OPTIMIZERS[name].MOMENTS[0]
        assert max(np.abs(a - b).max() for a, b in zip(plain[-1]["port"][1][k],
                                                        steps[-1]["port"][1][k])) > 1e-5


def test_dual_clip_norm_spans_both_nets(params0):
    """The dual trainer's one optimizer over both nets clips by one norm
    over both nets' gradients, as the JAX package's transform over the
    stacked pair does; a norm per net would give other parameters."""
    rng = np.random.default_rng(3)
    cfg = OptimConfig(lr=1e-2, grad_clip_norm=1.0, weight_decay=1e-4)
    jcfg = JOptimConfig(**vars(cfg))
    nets0 = [params0, [rng.normal(size=p.shape).astype(np.float32) for p in params0]]
    grads = [[g, [10.0 * x for x in g]] for g in _grad_sequence(4)]  # net 2's 10x larger
    tx = jsched.make_optimizer(jcfg, 2, 10)
    jp = [jnp.stack([jnp.asarray(a), jnp.asarray(b)]) for a, b in zip(*nets0)]
    state = tx.init(jp)
    nets = [[torch.nn.Parameter(torch.from_numpy(p.copy())) for p in net] for net in nets0]
    opt = schedules.make_optimizer(nets[0] + nets[1], cfg, 2, 10)
    per_net = [[torch.nn.Parameter(torch.from_numpy(p.copy())) for p in net] for net in nets0]
    per_net_opts = [schedules.make_optimizer(ps, cfg, 2, 10) for ps in per_net]
    for g1, g2 in grads:
        stacked = [jnp.stack([jnp.asarray(a), jnp.asarray(b)]) for a, b in zip(g1, g2)]
        upd, state = tx.update(stacked, state, jp)
        jp = optax.apply_updates(jp, upd)
        for ps_list in (nets, per_net):
            for ps, g in zip(ps_list, (g1, g2)):
                for p, x in zip(ps, g):
                    p.grad = torch.from_numpy(x.copy())
        opt.step()
        for o in per_net_opts:
            o.step()
    for n in range(2):
        for p, want in zip(nets[n], jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), rtol=1e-6, atol=1e-7)
    diff = max(float((a - b).detach().abs().max()) for n in range(2) for a, b in zip(nets[n], per_net[n]))
    assert diff > 1e-4


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
    """Every optimizer option of the JAX package is ported; only a name it
    does not know raises, as the JAX package's make_optimizer does."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    for name in ("rmsprop", "adamw"):
        with pytest.raises(ValueError, match="unknown optimizer"):
            schedules.make_optimizer(params, OptimConfig(optimizer=name), 4, 10)
        with pytest.raises(ValueError, match="unknown optimizer"):
            jsched.make_optimizer(JOptimConfig(optimizer=name), 4, 10)
    assert isinstance(schedules.make_optimizer(params, OptimConfig(), 4, 10), schedules.AMSGrad)
    opt = schedules.make_optimizer(
        params, OptimConfig(optimizer="sgd", grad_clip_norm=1.0, weight_decay=1e-4), 4, 10)
    assert isinstance(opt, schedules.SGD) and opt.grad_clip_norm == 1.0 and opt.weight_decay == 1e-4


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
