"""The port's FuseUNet and UNet against aide_tpu's, from the same variables.

JAX variables (FuseUNet plain at base width 4; the UNet family as unet4,
unet8 and the default unet at its width 64) go through interop.weights into
the port at 32 px. Logits in eval and in train mode to rtol/atol 1e-4 (f32
convolutions sum in another order); the updated BN running stats to 1e-5;
every JAX leaf maps to a port parameter or buffer and the reverse. A bare
state_dict and an AIDE ``{'net': ...}`` ``.pkl`` of a UNet both load.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core.config import ModelConfig as JModelConfig
from aide_tpu.interop import import_reference_checkpoint
from aide_tpu.models import build_model as j_build_model

from aide_tpu_torch.core.config import ModelConfig
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.interop import weights
from aide_tpu_torch.models import build_model, is_two_modal
from aide_tpu_torch.models.blocks import Norm
from aide_tpu_torch.models.fuseunet import FuseUNet
from aide_tpu_torch.models.unet import UNet


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
# (model name, base width override): fuseunet at 4, unet4, unet8, and the
# default unet at its own width 64
FAMILIES = [("fuseunet", 4), ("unet4", 0), ("unet8", 0), ("unet", 0)]


def _np_tree(t):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)


def _flat_stats(tree, prefix=()):
    out = {}
    for k, x in tree.items():
        if "mean" in x:
            out[prefix + (k,)] = x
        else:
            out.update(_flat_stats(x, prefix + (k,)))
    return out


def _unflatten(flat):
    root = {}
    for path, leaf in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return root


def _family(name):
    return "fuseunet" if name == "fuseunet" else "unet"


def _port_model(name, width):
    return build_model(ModelConfig(name=name, base_width=width, compute_dtype="float32"))


@pytest.fixture(scope="module", params=FAMILIES, ids=[n for n, _ in FAMILIES])
def setup(request):
    name, width = request.param
    jm = j_build_model(JModelConfig(name=name, base_width=width, compute_dtype="float32"))
    rng = np.random.default_rng(0)
    n_in = 2 if name == "fuseunet" else 1
    inputs = [rng.normal(size=(B, S, S, 3)).astype(np.float32) for _ in range(n_in)]
    v = _np_tree(jm.init(jax.random.key(0), *map(jnp.asarray, inputs), train=False))
    # move BN params and stats off their init values so the mapping shows
    noise = np.random.default_rng(1)
    perturb = lambda x, s: (x + s * noise.normal(size=x.shape)).astype(np.float32)
    params = jax.tree_util.tree_map(lambda x: perturb(x, 0.02), v["params"])
    stats = {
        k: {"mean": perturb(x["mean"], 0.1),
            "var": (x["var"] * (1.0 + 0.2 * np.abs(noise.normal(size=x["var"].shape)))).astype(np.float32)}
        for k, x in _flat_stats(v["batch_stats"]).items()
    }
    v = {"params": params, "batch_stats": _unflatten(stats)}
    tm = _port_model(name, width)
    weights.load_variables(tm.to(memory_format=torch.channels_last), v)
    return dict(name=name, width=width, jm=jm, v=v, tm=tm, inputs=inputs)


def _torch_inputs(setup):
    return [torch.from_numpy(x) for x in setup["inputs"]]


def _jax_inputs(setup):
    return [jnp.asarray(x) for x in setup["inputs"]]


def test_eval_logits_match(setup):
    tm = setup["tm"]
    tm.eval()
    with torch.no_grad():
        out = tm(*_torch_inputs(setup))
    ref = np.asarray(setup["jm"].apply(setup["v"], *_jax_inputs(setup), train=False))
    assert out.shape == (B, S, S, 2) and out.dtype == torch.float32
    assert out.is_contiguous()  # NHWC view of channels_last memory, no copy
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_train_logits_and_running_stats_match(setup):
    v = setup["v"]
    tm = _port_model(setup["name"], setup["width"])
    weights.load_variables(tm, v)
    tm.train()
    with torch.no_grad():
        out = tm(*_torch_inputs(setup))
    ref, upd = setup["jm"].apply(v, *_jax_inputs(setup), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    want = weights.variables_to_state_dict(
        {"params": v["params"], "batch_stats": _np_tree(upd["batch_stats"])}, _family(setup["name"])
    )
    got = tm.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_update_stats_false_leaves_running_stats(setup):
    tm = _port_model(setup["name"], setup["width"])
    weights.load_variables(tm, setup["v"])
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train()
    running = [k for k in before if "running" in k]
    with torch.no_grad():
        batch_mode = tm(*_torch_inputs(setup), update_stats=False)
    assert all(torch.equal(tm.state_dict()[k], before[k]) for k in running)
    with torch.no_grad():
        updating = tm(*_torch_inputs(setup))
    assert not any(torch.equal(tm.state_dict()[k], before[k]) for k in running)
    assert torch.equal(batch_mode, updating)  # both normalize with batch stats


def test_every_leaf_maps_both_ways(setup):
    v, tm, family = setup["v"], setup["tm"], _family(setup["name"])
    sd = weights.variables_to_state_dict(v, family)
    assert set(sd) == set(tm.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros(1, np.float32)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError):
        weights.variables_to_state_dict(extra, family)
    missing = {"params": {k: x for k, x in v["params"].items() if k != "Conv_0"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        weights.variables_to_state_dict(missing, family)
    # the other family's map leaves this tree's leaves unmapped or missing
    other = "unet" if family == "fuseunet" else "fuseunet"
    with pytest.raises((KeyError, ValueError)):
        weights.variables_to_state_dict(v, other)


@pytest.mark.parametrize("wrapped", [False, True])
def test_unet_pkl_loads_bare_and_wrapped(tmp_path, wrapped):
    """A bare state_dict and the AIDE trainers' {'net': state_dict, ...}
    file (with the num_batches_tracked buffers torch's BatchNorm writes)
    load into the port's UNet, and the JAX package reads the same file to
    the same weights."""
    src = build_model(ModelConfig(name="unet4", compute_dtype="float32"))
    torch.manual_seed(3)
    for p in src.parameters():
        p.data.normal_()
    sd = dict(src.state_dict())
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in src.state_dict() if k.endswith("running_mean")})
    path = str(tmp_path / "unet.pkl")
    torch.save({"net": sd, "epoch": 3, "loss": 0.5} if wrapped else sd, path)
    got = ckpt.load_net(path)
    assert set(got) == set(src.state_dict())
    dst = build_model(ModelConfig(name="unet4", compute_dtype="float32"))
    dst.load_state_dict(got, strict=True)
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    back = weights.variables_to_state_dict(import_reference_checkpoint(path, "unet4"), "unet")
    for k, t in src.state_dict().items():
        assert np.array_equal(back[k], t.numpy()), k


def test_norm_folds_biased_variance_with_flax_momentum():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 4, 5) * 2.0 + 1.0
    n = Norm(3)
    n.train()
    n(x)
    var_biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(n.running_mean, 0.1 * x.mean(dim=(0, 2, 3)), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(n.running_var, 0.9 + 0.1 * var_biased, rtol=1e-5, atol=1e-6)


def test_reference_state_dict_names():
    tm = FuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    names = set(tm.state_dict())
    for name in ("modal1_downblock3.block.conv1.weight", "modal2_downblock5.block.bn2.running_var",
                 "up_block2.bilinear_up.1.weight", "up_block2.bilinear_up.2.running_mean",
                 "up_block4.block.conv2.bias", "last_conv1.weight"):
        assert name in names
    names = set(UNet(num_classes=2, base_width=4).state_dict())
    for name in ("down_block1.block.conv1.weight", "down_block5.block.bn2.running_var",
                 "up_block1.bilinear_up.1.weight", "up_block4.bilinear_up.2.running_mean",
                 "up_block3.block.conv2.bias", "last_conv1.weight"):
        assert name in names


@pytest.mark.parametrize("name,width", [("unet", 64), ("unet2", 2), ("unet16", 16),
                                        ("unet32", 32), ("unet128", 128)])
def test_unet_registry_widths(name, width):
    m = build_model(ModelConfig(name=name))
    assert isinstance(m, UNet) and m.down_block1.block.conv1.out_channels == width
    m = build_model(ModelConfig(name=name, base_width=6))
    assert m.down_block5.block.conv2.out_channels == 16 * 6


@pytest.mark.parametrize("override", [
    dict(name="unetsa"), dict(name="fuseunetsa"), dict(norm="group"),
    dict(learned_bilinear=True), dict(remat=True),
])
def test_build_model_raises_for_unported(override):
    """The five configurations the port refused before its model zoo was
    ported (unetsa, fuseunetsa, GroupNorm, the learned upsample, remat, at
    their default widths) now build, and each matches the JAX model: the
    same variable names and shapes, and eval logits of the same weights to
    1e-4 (tests/test_torch_zoo.py holds every option in both modes)."""
    cfg = ModelConfig(compute_dtype="float32", **override)
    tm = build_model(cfg).eval()
    two_modal = is_two_modal(cfg.name)
    x = [np.random.default_rng(1).normal(size=(1, 16, 16, 3)).astype(np.float32)
         for _ in range(1 + two_modal)]
    v = weights.state_dict_to_variables(tm.state_dict(), **tm.arch)
    jm = j_build_model(JModelConfig(compute_dtype="float32", **override))
    jx = [jnp.asarray(a) for a in x]
    shapes = jax.eval_shape(lambda *a: jm.init(jax.random.key(0), *a, train=False), *jx)
    assert weights.leaf_paths(v) == weights.leaf_paths(shapes)
    with torch.no_grad():
        out = tm(*[torch.from_numpy(a) for a in x]).numpy()
    ref = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(v, *jx))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_build_model_accepts_packed_keys():
    m = build_model(ModelConfig(packed=True, packed_block_barrier=False, base_width=4))
    assert isinstance(m, FuseUNet)
