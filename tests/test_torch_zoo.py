"""The port's model zoo against aide_tpu's: every model option, the blocks, remat.

On the CPU, in f32 unless said otherwise. Weights are the port's own initialisation
(``init_net``) with the norm parameters and BatchNorm statistics moved off
their initial values, carried into the JAX package through
``interop.weights.state_dict_to_variables``; its leaf names and shapes must
equal the JAX model's own init tree, and the map must give the state_dict
back. The bars:
- logits of ``unetsa``, ``fuseunetsa``, ``fuseunetsaseparate``, GroupNorm,
  the learned upsample and remat on the UNet and the FuseUNet, in eval and
  in train mode, to rtol/atol 1e-4 (``test_torch_model.py``'s bar), and the
  BatchNorm statistics a train forward folds to 1e-5. The attention models
  are held in float64 instead, both packages computing in it (the JAX
  package's ``resolve_dtype`` patched under ``jax.enable_x64``), to 1e-6 on
  the float32 logits: in float32 the JAX reference itself sits 1.2e-4 to
  2.4e-4 in train mode from a float64 evaluation of the same weights (the
  gates' one-channel batch statistics carry the rounding of every level
  below), so a 1e-4 bar between the packages would test rounding;
- each block (``ChannelAttention``, ``SpatialAttention`` with both norms,
  ``BottleneckAttention``, ``CAUpBlock`` with and without ``residual``,
  ``FeatureRefine``) in both modes to 1e-5;
- GroupNorm's group count at C = 6, 8 and 12 with groups = 8 (6, 8, 6);
- remat: the same loss, gradients to 1e-5 and running statistics equal to a
  plain step's, though the recompute ran every BatchNorm a second time;
- one co-teaching step of a GroupNorm UNet and of ``fuseunetsa`` against
  the JAX step (``test_torch_step.py``'s bars, its 2*lr rule included);
- two epochs of ``Trainer.run`` on a cut of the ``synthetic_smoke`` preset
  (GroupNorm UNet) against the JAX trainer: history within
  ``test_torch_epoch.py``'s bars and an identical ``refresh_log``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.cli.presets import get_preset as j_get_preset
from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.state import DualTrainState as JDualState
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.models import blocks as jblocks
from aide_tpu.models import build_model as j_build_model
from aide_tpu.ops import make_optimizer as j_make_optimizer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.cli.presets import get_preset
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.engine.state import DualTrainState
from aide_tpu_torch.interop import weights
from aide_tpu_torch.models import blocks, build_model
from aide_tpu_torch.ops import losses
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


S, B = 32, 3
# their float32 train-mode rounding exceeds the bar (module docstring)
ATTENTION = {"unetsa", "fuseunetsa", "fuseunetsaseparate"}
MODELS = {
    "unetsa": dict(name="unetsa", base_width=2),
    "fuseunetsa": dict(name="fuseunetsa", base_width=2),
    "fuseunetsaseparate": dict(name="fuseunetsaseparate", base_width=2),
    "unet_group": dict(name="unet4", norm="group"),
    "fuseunet_group": dict(name="fuseunet", base_width=2, norm="group"),
    "unet_learned_bilinear": dict(name="unet2", learned_bilinear=True),
    "fuseunet_learned_bilinear": dict(name="fuseunet", base_width=2, learned_bilinear=True),
    "unet_remat": dict(name="unet2", remat=True),
    "fuseunet_remat": dict(name="fuseunet", base_width=2, remat=True),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_norms(module, seed):
    """Norm scales and biases and BN statistics off their initial values,
    so that the name map of each shows in the outputs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (blocks.BatchNorm, blocks.GroupNorm)):
                m.weight.add_(0.05 * torch.randn(m.weight.shape, generator=gen))
                m.bias.add_(0.05 * torch.randn(m.bias.shape, generator=gen))
            if isinstance(m, blocks.BatchNorm):
                m.running_mean.add_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.mul_(1.0 + 0.2 * torch.rand(m.running_var.shape, generator=gen))


def _init_paths(jmodule, *inputs):
    shapes = jax.eval_shape(lambda *x: jmodule.init(jax.random.key(0), *x, train=False), *inputs)
    return weights.leaf_paths(shapes)


def _jax_outputs(jmodule, v, inputs, f64):
    """One program: eval output, train output and the folded BN stats; in
    float64 (the JAX package's ``resolve_dtype`` patched under
    ``jax.enable_x64``) when ``f64``."""
    def run(v, *x):
        train, upd = jmodule.apply(v, *x, train=True, mutable=["batch_stats"])
        return jmodule.apply(v, *x, train=False), train, upd
    if not f64:
        return _np(jax.jit(run)(v, *map(jnp.asarray, inputs)))
    resolve = jblocks.resolve_dtype
    with jax.enable_x64(True):
        jblocks.resolve_dtype = lambda name: jnp.float64
        try:
            v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
            return _np(jax.jit(run)(v, *[jnp.asarray(x, jnp.float64) for x in inputs]))
        finally:
            jblocks.resolve_dtype = resolve


def _port_outputs(module, inputs):
    out = {}
    for mode in (False, True):
        module.train(mode)
        with torch.no_grad():
            out[mode] = module(*[torch.from_numpy(x) for x in inputs])
    return out


@pytest.fixture(scope="module", params=list(MODELS), ids=list(MODELS))
def model_case(request):
    over = MODELS[request.param]
    f64 = request.param in ATTENTION
    two_modal = over["name"].startswith("fuseunet")
    net = ttrainer.init_net(ModelConfig(compute_dtype="float32", **over), seed=0)
    net = net.to(memory_format=torch.channels_last)
    _perturb_norms(net, 1)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    v = weights.state_dict_to_variables(sd, **net.arch)
    jm = j_build_model(JModelConfig(compute_dtype="float32", **over))
    rng = np.random.default_rng(0)
    inputs = [rng.normal(size=(B, S, S, 3)).astype(np.float32) for _ in range(1 + two_modal)]
    paths = _init_paths(jm, *map(jnp.asarray, inputs))
    j_eval, j_train, j_upd = _jax_outputs(jm, v, inputs, f64)
    if f64:
        net, inputs = net.double(), [x.astype(np.float64) for x in inputs]
    return dict(net=net, sd=sd, v=v, paths=paths, j_eval=j_eval, j_train=j_train,
                j_stats=j_upd.get("batch_stats", {}), port=_port_outputs(net, inputs),
                tol=1e-6 if f64 else 1e-4)


def test_zoo_names_map_both_ways(model_case):
    v, sd, net = model_case["v"], model_case["sd"], model_case["net"]
    assert weights.leaf_paths(v) == model_case["paths"]
    back = weights.variables_to_state_dict(v, **net.arch)
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert np.array_equal(back[k], t.numpy()), k


def test_zoo_eval_logits_match(model_case):
    out, tol = model_case["port"][False], model_case["tol"]
    assert out.shape == model_case["j_eval"].shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), model_case["j_eval"], rtol=tol, atol=tol)


def test_zoo_train_logits_and_stats_match(model_case):
    out, tol = model_case["port"][True], model_case["tol"]
    assert out.dtype == torch.float32 and model_case["j_train"].dtype == np.float32
    np.testing.assert_allclose(out.numpy(), model_case["j_train"], rtol=tol, atol=tol)
    net = model_case["net"]
    if net.arch["norm"] != "batch":
        assert not model_case["j_stats"]
        return
    want = weights.variables_to_state_dict(
        {"params": model_case["v"]["params"], "batch_stats": model_case["j_stats"]}, **net.arch)
    got = net.state_dict()  # after the port's one train forward
    running = [k for k in want if "running" in k]
    assert running
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_init_weights_use_flax_fan_in():
    """ConvTranspose2d and Linear kernels are lecun_normal over flax's
    fan-in (input channels x taps), their biases 0; GroupNorm starts at
    ones and zeros."""
    net = ttrainer.init_net(ModelConfig(name="unet", base_width=16, norm="group",
                                        learned_bilinear=True), seed=0)
    convT = net.up_block1.bilinear_up[0]
    assert isinstance(convT, torch.nn.ConvTranspose2d) and convT.in_channels == 256
    np.testing.assert_allclose(float(convT.weight.detach().std()), (1.0 / (256 * 4)) ** 0.5,
                               rtol=0.05)
    assert float(convT.bias.detach().abs().max()) == 0.0
    gn = net.down_block1.block.bn1
    assert isinstance(gn, blocks.GroupNorm)
    assert torch.equal(gn.weight, torch.ones(16)) and torch.equal(gn.bias, torch.zeros(16))
    ca = ttrainer.init_weights(blocks.ChannelAttention(1024, 2), seed=0)
    np.testing.assert_allclose(float(ca.fc1.weight.detach().std()), (1.0 / 1024) ** 0.5, rtol=0.05)
    np.testing.assert_allclose(float(ca.fc2.weight.detach().std()), (1.0 / 512) ** 0.5, rtol=0.05)
    assert float(ca.fc1.bias.detach().abs().max()) == 0.0


# ------------------------------- blocks -------------------------------

BLOCK_C, BLOCK_S = 8, 16
BLOCKS = {
    "ChannelAttention": dict(block="ChannelAttention"),
    "SpatialAttention_batch": dict(block="SpatialAttention", norm="batch"),
    "SpatialAttention_group": dict(block="SpatialAttention", norm="group"),
    "BottleneckAttention": dict(block="BottleneckAttention", norm="batch"),
    "CAUpBlock": dict(block="CAUpBlock", residual=False),
    "CAUpBlock_residual": dict(block="CAUpBlock", residual=True),
    "FeatureRefine": dict(block="FeatureRefine", norm="batch"),
}


def _block_pair(spec):
    """(JAX block, port block, NHWC inputs, takes train)."""
    f32 = jnp.float32
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, BLOCK_S, BLOCK_S, BLOCK_C)).astype(np.float32) + 0.5
    kind, norm = spec["block"], spec.get("norm", "batch")
    if kind == "ChannelAttention":
        return jblocks.ChannelAttention(4, f32), blocks.ChannelAttention(BLOCK_C, 4), [x], False
    if kind == "SpatialAttention":
        return (jblocks.SpatialAttention(4, 2, norm, 8, None, f32),
                blocks.SpatialAttention(BLOCK_C, 4, 2, norm), [x], True)
    if kind == "BottleneckAttention":
        return (jblocks.BottleneckAttention(4, 2, norm, None, f32),
                blocks.BottleneckAttention(BLOCK_C, 4, 2, norm), [x], True)
    if kind == "FeatureRefine":
        return jblocks.FeatureRefine(BLOCK_C, norm, 8, None, f32), blocks.FeatureRefine(BLOCK_C), [x], True
    skip = rng.normal(size=(B, 2 * BLOCK_S, 2 * BLOCK_S, 4)).astype(np.float32)
    return (jblocks.CAUpBlock(4, 6, spec["residual"], False, 4, "batch", 8, None, f32),
            blocks.CAUpBlock(BLOCK_C, 4, 6, spec["residual"], False, 4), [skip, x], True)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    spec = BLOCKS[name]
    jb, tb, inputs, has_train = _block_pair(spec)
    ttrainer.init_weights(tb, seed=4)
    _perturb_norms(tb, 2)
    table = weights.block_name_map(spec["block"], spec.get("norm", "batch"))
    v = weights.state_dict_to_tables(tb.state_dict(), table)
    jx = [jnp.asarray(a) for a in inputs]
    kw = dict(train=False) if has_train else {}
    shapes = jax.eval_shape(lambda *x: jb.init(jax.random.key(0), *x, **kw), *jx)
    assert weights.leaf_paths(v) == weights.leaf_paths(shapes)
    tx = [torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))) for a in inputs]
    for mode in ((False, True) if has_train else (False,)):
        tb.train(mode)
        with torch.no_grad():
            got = tb(*tx).numpy()
        if has_train:
            want, _ = jb.apply(v, *jx, train=mode, mutable=["batch_stats"])
        else:
            want = jb.apply(v, *jx)
        np.testing.assert_allclose(np.moveaxis(got, 1, -1), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"train={mode}")


@pytest.mark.parametrize("channels,groups", [(6, 6), (8, 8), (12, 6)])
def test_group_norm_group_count(channels, groups):
    """flax's rule: min(8, C), stepped down until it divides C."""
    norm = blocks.Norm(channels, "group", 8)
    assert norm.num_groups == groups
    _perturb_norms(norm, channels)
    x = np.random.default_rng(channels).normal(3.0, 2.0, size=(2, 5, 5, channels)).astype(np.float32)
    jn = jblocks.Norm("group", 8, None, jnp.float32)
    v = {"params": {"GroupNorm_0": {"scale": norm.weight.detach().numpy(),
                                    "bias": norm.bias.detach().numpy()}}}
    want = np.asarray(jn.apply(v, jnp.asarray(x)))
    for mode in (False, True):  # no running statistics: one output
        norm.train(mode)
        got = norm(torch.from_numpy(np.moveaxis(x, -1, 1).copy())).detach().numpy()
        np.testing.assert_allclose(np.moveaxis(got, 1, -1), want, rtol=1e-5, atol=1e-5)


# -------------------------------- remat --------------------------------


@pytest.mark.parametrize("name", ["unet2", "fuseunet"])
def test_remat_same_loss_grads_and_stats_folded_once(name):
    """A train step with remat against one without, from the same weights:
    the same loss, gradients to 1e-5, and the same running statistics,
    though the recompute in the backward pass ran every BatchNorm again."""
    two_modal = name == "fuseunet"
    rng = np.random.default_rng(5)
    x = [torch.from_numpy(rng.normal(size=(2, S, S, 3)).astype(np.float32))
         for _ in range(1 + two_modal)]
    t = torch.from_numpy((rng.random((2, S, S)) < 0.3).astype(np.int64))
    out = {}
    for remat in (False, True):
        net = ttrainer.init_net(ModelConfig(name=name, base_width=2, compute_dtype="float32",
                                            remat=remat), seed=0)
        calls = []
        for m in net.modules():
            if isinstance(m, blocks.BatchNorm):
                m.register_forward_hook(lambda *_: calls.append(1))
        net.train()
        loss = losses.cem_dice_loss(net(*x), t)
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad.clone() for k, p in net.named_parameters()},
                      {k: b.clone() for k, b in net.named_buffers()}, len(calls))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out[False], out[True]
    n_norms = sum(isinstance(m, blocks.BatchNorm) for m in net.modules())
    assert n0 == n_norms and n1 > n0  # the recompute ran the blocks' norms again
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-5, msg=k)
    for k in s0:
        assert torch.equal(s1[k], s0[k]), k


# --------------------------- co-teaching step ---------------------------

LR = 1e-4
STEP_MODELS = {
    "unet_group": (dict(name="unet", base_width=4, norm="group"), False),
    "fuseunetsa": (dict(name="fuseunetsa", base_width=2), True),
}


def _step_batch(b, two_modal, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m in (("1", "2") if two_modal else ("",)):
        out[f"modal{m}" if two_modal else "image"] = rng.integers(0, 256, size=(b, S, S, 3),
                                                                 dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, size=(b, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, size=(b, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in ("target1", "target2"):
        cy, cx, r = rng.uniform(8, 24), rng.uniform(8, 24), rng.uniform(4, 10)
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int32)
        out[t] = np.stack([np.roll(base, int(rng.integers(-3, 4)), axis=1) for _ in range(b)])
    return out


@pytest.fixture(scope="module", params=list(STEP_MODELS), ids=list(STEP_MODELS))
def coteach_step(request):
    over, two_modal = STEP_MODELS[request.param]
    b, views = 4, 2
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(compute_dtype="float32", **over)
    jcfg.data.img_size = S
    jcfg.data.batch_size = b
    jcfg.data.num_tta_views = views
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    nets = [ttrainer.init_net(cfg.model, seed).to(memory_format=torch.channels_last)
            for seed in (0, 1)]
    for i, net in enumerate(nets):
        _perturb_norms(net, 10 + i)
    vs = [weights.state_dict_to_variables(n.state_dict(), **n.arch) for n in nets]
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10, num_epochs=10)
    jstate = JDualState.create(vs[0], vs[1], tx)
    jstep = jsteps.make_coteach_train_step(j_build_model(jcfg.model), two_modal, jcfg)
    params = [p for n in nets for p in n.parameters()]
    state = DualTrainState(nets[0], nets[1], make_optimizer(params, cfg.optim, 10, 10))
    step = steps.make_coteach_train_step(two_modal, cfg)

    batch = _step_batch(b, two_modal, seed=10)
    key = jax.random.key(100)
    degrees, hflip = jtta.sample_view_params(key, views, b, jcfg.data.rotation_degree,
                                             jcfg.data.hflip_prob)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                       jnp.asarray(0.5, jnp.float32))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["target1"] = tbatch["target1"].long()
    tbatch["target2"] = tbatch["target2"].long()
    tm = step(state, tbatch, torch.from_numpy(np.array(degrees)),
              torch.from_numpy(np.array(hflip)), 0.5)
    return dict(
        jm={k: float(v) for k, v in jm.items()}, tm={k: float(v) for k, v in tm.items()},
        jvars=[_np(jstate.net_variables(n)) for n in (0, 1)], jmu=_np(jstate.opt_state[0].mu),
        port=[{k: v.detach().numpy() for k, v in n.state_dict().items()} for n in nets],
        arch=nets[0].arch, step=state.step,
    )


def test_coteach_step_metrics(coteach_step):
    for key in ("loss1", "loss2", "dice1_sum", "dice2_sum", "count"):
        np.testing.assert_allclose(coteach_step["tm"][key], coteach_step["jm"][key], rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("net", [0, 1])
def test_coteach_step_new_params(coteach_step, net):
    """test_torch_step.py's bars: parameters to atol 1e-6 + 1e-2*lr, the
    sign-noise elements (under 5% of their tensor's largest gradient, and
    every conv bias that feeds a norm) to 2*lr, BN stats to rtol 1e-4."""
    arch, jvars = coteach_step["arch"], coteach_step["jvars"][net]
    assert coteach_step["step"] == 1
    ref = weights.variables_to_state_dict(jvars, **arch)
    grad = weights.variables_to_state_dict({
        "params": jax.tree_util.tree_map(lambda x: x[net] / 0.1, coteach_step["jmu"]),
        **({"batch_stats": jvars["batch_stats"]} if "batch_stats" in jvars else {}),
    }, **arch)
    got = coteach_step["port"][net]
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if "running" in k:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-7, err_msg=k)
            continue
        feeds_norm = (
            k.endswith(".bias") and k != "last_conv1.bias" and ".bn" not in k
            and not k.endswith("bilinear_up.2.bias")
        )
        strict = 1e-6 + 1e-2 * LR
        noise = np.abs(grad[k]) < 5e-2 * np.abs(grad[k]).max()
        if feeds_norm:
            noise[...] = True
        bad = np.abs(g - r) > np.where(noise, 2 * LR, strict)
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - r).max()))
        if not feeds_norm:
            flipped = int((np.abs(g - r) > strict).sum())
            assert flipped <= max(1, 0.05 * g.size), (k, flipped, g.size)


# ------------------------------ two epochs ------------------------------

EPOCHS = 2
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=False, num_cases=4, slices_per_case=4,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    """synthetic_smoke cut: base width 2, 32 px, 4 train cases x 4 slices,
    lr 1e-6 (test_torch_epoch.py's reason), eval batch 3."""
    tmp = tmp_path_factory.mktemp("smoke")
    jcfg = j_get_preset("synthetic_smoke")
    jcfg.model.base_width = 2
    jcfg.data.img_size = 32
    jcfg.data.eval_batch_size = 3
    jcfg.optim.lr = 1e-6
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir, jcfg.history_dir = str(tmp / "jckpt"), str(tmp / "jhist")
    cfg = get_preset("synthetic_smoke")
    assert cfg.to_dict() == j_get_preset("synthetic_smoke").to_dict()
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    cfg.checkpoint_dir, cfg.history_dir = str(tmp / "ckpt"), str(tmp / "hist")
    jtask = JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS)
    task = SyntheticTask(root=str(tmp / "t"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    tr = ttrainer.Trainer(cfg, task, device="cpu")
    jtr.label_cases = set(jtask.clean_case_ids())
    tr.label_cases = set(task.clean_case_ids())
    for n, net in enumerate(tr.state.nets):
        assert isinstance(net.down_block1.block.bn1, blocks.GroupNorm)
        weights.load_variables(net, _np(jtr.state.net_variables(n)))

    def jax_views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(key, cfg.data.num_tta_views, batch,
                                       cfg.data.rotation_degree, cfg.data.hflip_prob)
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    tr.view_params = jax_views
    jtr.run(EPOCHS)
    tr.run(EPOCHS)
    return jtr, tr


def test_smoke_epochs_refresh_log_identical(smoke_runs):
    jtr, tr = smoke_runs
    assert len(tr.refresh_log) == 2 * EPOCHS
    assert tr.refresh_log == jtr.refresh_log


def test_smoke_epochs_history_matches(smoke_runs):
    jtr, tr = smoke_runs
    assert len(tr.history) == len(jtr.history) == EPOCHS
    for j, t in zip(jtr.history, tr.history):
        assert set(t) == set(j)
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")
