"""The port's FuseUNet against aide_tpu's, from the same variables.

JAX FuseUNet (plain) variables go through interop.weights into the port at
base width 4 and 32 px. Logits in eval and in train mode to rtol/atol 1e-4
(f32 convolutions sum in another order); the updated BN running stats to
1e-5; every JAX leaf maps to a port parameter or buffer and the reverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.models.fuseunet import FuseUNet as JFuseUNet

from aide_tpu_torch.core.config import ModelConfig
from aide_tpu_torch.interop import weights
from aide_tpu_torch.models import build_model
from aide_tpu_torch.models.blocks import Norm
from aide_tpu_torch.models.fuseunet import FuseUNet

S, B = 32, 3


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


@pytest.fixture(scope="module")
def setup():
    jm = JFuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    b = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    v = _np_tree(jm.init(jax.random.key(0), jnp.asarray(a), jnp.asarray(b), train=False))
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
    tm = FuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    weights.load_variables(tm.to(memory_format=torch.channels_last), v)
    return jm, v, tm, a, b


def test_eval_logits_match(setup):
    jm, v, tm, a, b = setup
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(a), torch.from_numpy(b))
    ref = np.asarray(jm.apply(v, jnp.asarray(a), jnp.asarray(b), train=False))
    assert out.shape == (B, S, S, 2) and out.dtype == torch.float32
    assert out.is_contiguous()  # NHWC view of channels_last memory, no copy
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_train_logits_and_running_stats_match(setup):
    jm, v, _, a, b = setup
    tm = FuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    weights.load_variables(tm, v)
    tm.train()
    with torch.no_grad():
        out = tm(torch.from_numpy(a), torch.from_numpy(b))
    ref, upd = jm.apply(v, jnp.asarray(a), jnp.asarray(b), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    want = weights.variables_to_state_dict({"params": v["params"], "batch_stats": _np_tree(upd["batch_stats"])})
    got = tm.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_update_stats_false_leaves_running_stats(setup):
    _, v, _, a, b = setup
    tm = FuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    weights.load_variables(tm, v)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train()
    running = [k for k in before if "running" in k]
    with torch.no_grad():
        batch_mode = tm(torch.from_numpy(a), torch.from_numpy(b), update_stats=False)
    assert all(torch.equal(tm.state_dict()[k], before[k]) for k in running)
    with torch.no_grad():
        updating = tm(torch.from_numpy(a), torch.from_numpy(b))
    assert not any(torch.equal(tm.state_dict()[k], before[k]) for k in running)
    assert torch.equal(batch_mode, updating)  # both normalize with batch stats


def test_every_leaf_maps_both_ways(setup):
    _, v, tm, _, _ = setup
    sd = weights.variables_to_state_dict(v)
    assert set(sd) == set(tm.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros(1, np.float32)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError):
        weights.variables_to_state_dict(extra)
    missing = {"params": {k: x for k, x in v["params"].items() if k != "Conv_0"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        weights.variables_to_state_dict(missing)


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


@pytest.mark.parametrize("override", [
    dict(name="unet"), dict(name="fuseunetsa"), dict(norm="group"),
    dict(learned_bilinear=True), dict(remat=True),
])
def test_build_model_raises_for_unported(override):
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(**override))


def test_build_model_accepts_packed_keys():
    m = build_model(ModelConfig(packed=True, packed_block_barrier=False, base_width=4))
    assert isinstance(m, FuseUNet)
