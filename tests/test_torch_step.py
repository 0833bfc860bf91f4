"""One co-teaching step of the port against the JAX package's, in f32.

Same weights, same batch, same TTA view parameters (drawn with the key the
JAX step uses) and rate 0.5. Losses and dice sums to rtol 1e-4, the new BN
running stats to rtol 1e-4, the new parameters to atol 1e-6 + 1e-2*lr, and
a second step's losses to rtol 1e-3. With ``coteach.tta_bn="running"`` (the
view forwards in eval-mode BN) one step's losses, dice sums and BN running
stats are held the same way.

AMSGrad's first update moves every parameter by lr * g/|g|: by lr in the
direction of its gradient's sign. Where the sign is not determined in f32,
the two packages may move a parameter in opposite directions, 2*lr apart.
That holds for every conv bias that feeds a BatchNorm (the norm removes it:
its gradient is zero up to rounding), and for weight elements whose gradient
is small next to its tensor's largest: the JAX package's f32 CPU gradient of
this network differs from a float64 evaluation by up to a few percent of a
tensor's largest element, where the port's f32 gradient stays within 1e-5
of it. Elements under 5% of their tensor's largest gradient are therefore
held at 2*lr, and the ones that do move apart must stay under 5% of each
tensor (one in a small one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.state import DualTrainState as JDualState
from aide_tpu.models.fuseunet import FuseUNet as JFuseUNet
from aide_tpu.ops import make_optimizer as j_make_optimizer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine.state import DualTrainState
from aide_tpu_torch.interop.weights import load_variables, variables_to_state_dict
from aide_tpu_torch.models.fuseunet import FuseUNet
from aide_tpu_torch.ops.schedules import make_optimizer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S = 32
V = 2
LR = 1e-4


def _cfgs(b, tta_bn="batch"):
    jcfg = JTrainConfig()
    jcfg.coteach.tta_bn = tta_bn
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.img_size = S
    jcfg.data.batch_size = b
    jcfg.data.num_tta_views = V
    jcfg.data.warp_method = "shear"
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    return jcfg, cfg


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m in ("1", "2"):
        out[f"modal{m}"] = rng.integers(0, 256, size=(b, S, S, 3), dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, size=(b, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, size=(b, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in ("target1", "target2"):
        cy, cx, r = rng.uniform(8, 24), rng.uniform(8, 24), rng.uniform(4, 10)
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int32)
        out[t] = np.stack([np.roll(base, int(rng.integers(-3, 4)), axis=1) for _ in range(b)])
    return out


def _np_tree(t):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), t)


def _run_both(b, n_steps, tta_bn="batch"):
    jcfg, cfg = _cfgs(b, tta_bn)
    jmodel = JFuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    x = jnp.zeros((1, S, S, 3))
    v1 = jmodel.init(jax.random.key(0), x, x, train=False)
    v2 = jmodel.init(jax.random.key(1), x, x, train=False)
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10, num_epochs=10)
    jstate = JDualState.create(v1, v2, tx)
    jstep = jsteps.make_coteach_train_step(jmodel, True, jcfg)

    nets = []
    for v in (v1, v2):
        net = FuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
        load_variables(net.to(memory_format=torch.channels_last), _np_tree(v))
        nets.append(net)
    params = [p for n in nets for p in n.parameters()]
    state = DualTrainState(nets[0], nets[1], make_optimizer(params, cfg.optim, 10, 10))
    step = steps.make_coteach_train_step(True, cfg)

    results, after_first = [], None
    for i in range(n_steps):
        batch = _batch(b, seed=10 + i)
        key = jax.random.key(100 + i)
        degrees, hflip = jtta.sample_view_params(
            key, V, b, jcfg.data.rotation_degree, jcfg.data.hflip_prob
        )
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                           jnp.asarray(0.5, jnp.float32))
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        tbatch["target1"] = tbatch["target1"].long()
        tbatch["target2"] = tbatch["target2"].long()
        tm = step(state, tbatch, torch.from_numpy(np.array(degrees)),
                  torch.from_numpy(np.array(hflip)), 0.5)
        results.append(({k: float(v) for k, v in jm.items()}, {k: float(v) for k, v in tm.items()}))
        if i == 0:
            # the JAX step donates its state: copy what the tests read
            after_first = (
                [_np_tree(jstate.net_variables(n)) for n in (0, 1)],
                _np_tree(jstate.opt_state[0].mu),
                [{k: v.detach().clone().numpy() for k, v in net.state_dict().items()} for net in nets],
                state.step,
            )
    return after_first, results


@pytest.fixture(scope="module")
def two_steps():
    return _run_both(4, 2)


@pytest.mark.parametrize("key", ["loss1", "loss2", "dice1_sum", "dice2_sum", "count"])
def test_step_metrics(two_steps, key):
    _, results = two_steps
    jm, tm = results[0]
    np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4)


@pytest.mark.parametrize("net", [0, 1])
def test_step_new_params_and_stats(two_steps, net):
    (jvars, jmu, port_sd, port_step), _ = two_steps
    assert port_step == 1
    ref = variables_to_state_dict(jvars[net])
    # optax's first moment after one step is (1 - b1) * grad
    grad = variables_to_state_dict({
        "params": jax.tree_util.tree_map(lambda x: x[net] / 0.1, jmu),
        "batch_stats": jvars[net]["batch_stats"],
    })
    got = port_sd[net]
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if "running" in k:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-7, err_msg=k)
            continue
        feeds_bn = (
            k.endswith(".bias") and k != "last_conv1.bias" and ".bn" not in k
            and not k.endswith("bilinear_up.2.bias")
        )
        strict = 1e-6 + 1e-2 * LR
        noise = np.abs(grad[k]) < 5e-2 * np.abs(grad[k]).max()
        if feeds_bn:
            noise[...] = True
        bad = np.abs(g - r) > np.where(noise, 2 * LR, strict)
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - r).max()))
        if not feeds_bn:
            flipped = int((np.abs(g - r) > strict).sum())
            assert flipped <= max(1, 0.05 * g.size), (k, flipped, g.size)


def test_second_step_losses(two_steps):
    _, results = two_steps
    jm, tm = results[1]
    for key in ("loss1", "loss2"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3)


@pytest.fixture(scope="module")
def running_step():
    return _run_both(4, 1, tta_bn="running")


@pytest.mark.parametrize("key", ["loss1", "loss2", "dice1_sum", "dice2_sum", "count"])
def test_step_metrics_tta_bn_running(running_step, two_steps, key):
    """The views' forwards in eval-mode BN (the running statistics) give
    the JAX step's metrics too, and losses that differ from the batch
    statistics' by more than the bar."""
    jm, tm = running_step[1][0]
    np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4)
    if key.startswith("loss"):
        assert abs(tm[key] - two_steps[1][0][1][key]) > 2e-4 * abs(tm[key])


@pytest.mark.parametrize("net", [0, 1])
def test_step_running_stats_tta_bn_running(running_step, net):
    (jvars, _, port_sd, port_step), _ = running_step
    assert port_step == 1
    ref = variables_to_state_dict(jvars[net])
    for k, r in ref.items():
        if "running" in k:
            np.testing.assert_allclose(port_sd[net][k], r, rtol=1e-4, atol=1e-7, err_msg=k)
