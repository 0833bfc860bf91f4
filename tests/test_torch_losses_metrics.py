"""The port's losses and Dice against aide_tpu.ops.losses / metrics.

Each loss with and without class weights at rtol 1e-5; ``dice_fn`` and
``_dice_vector`` including the empty-mask rules (both empty -> 1, a
prediction on an empty target -> 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.ops import losses as jl
from aide_tpu.ops import metrics as jm

from aide_tpu_torch.ops import losses as tl
from aide_tpu_torch.ops import metrics as tm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, S = 3, 16


def _case(c=2, seed=0, one_hot=False, ignore=False):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.normal(size=(B, S, S, c))).astype(np.float32)
    t = rng.integers(0, c, size=(B, S, S)).astype(np.int32)
    if ignore:
        t[0, :3, :5] = 255
    if one_hot:
        t = np.eye(c, dtype=np.float32)[t]
    return logits, t


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=1e-6)


WEIGHTS = [None, (0.3, 1.7)]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weight", WEIGHTS)
def test_cross_entropy_2d(weight, reduction):
    logits, t = _case(seed=1, ignore=True)
    ref = jl.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(t), weight, reduction)
    out = tl.cross_entropy_2d(_t(logits), _t(t), weight, reduction)
    _close(out.numpy(), ref)


def test_cross_entropy_one_hot_targets():
    logits, t = _case(c=3, seed=2, one_hot=True)
    _close(tl.cross_entropy_2d(_t(logits), _t(t)).numpy(),
           jl.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(t)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_soft_dice_from_probs(reduction):
    rng = np.random.default_rng(3)
    p = rng.random((B, S, S)).astype(np.float32)
    t = (rng.random((B, S, S)) < 0.3).astype(np.int32)
    _close(tl.soft_dice_from_probs(_t(p), _t(t), reduction=reduction).numpy(),
           jl.soft_dice_from_probs(jnp.asarray(p), jnp.asarray(t), reduction=reduction))


@pytest.mark.parametrize("weight", [None, (0.5, 1.0, 2.0)])
@pytest.mark.parametrize("one_hot", [False, True])
def test_multiclass_dice_loss(one_hot, weight):
    c = 3 if one_hot else 2
    logits, t = _case(c=c, seed=4, one_hot=one_hot)
    w = weight if one_hot else (weight[:2] if weight else None)
    for reduction in ("mean", "none"):
        _close(tl.multiclass_dice_loss(_t(logits), _t(t), w, reduction=reduction).numpy(),
               jl.multiclass_dice_loss(jnp.asarray(logits), jnp.asarray(t), w, reduction=reduction))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_multiclass_mse_loss(reduction):
    logits, _ = _case(seed=5)
    rng = np.random.default_rng(6)
    p = rng.random((B, S, S, 2)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    _close(tl.multiclass_mse_loss(_t(logits), _t(p), reduction).numpy(),
           jl.multiclass_mse_loss(jnp.asarray(logits), jnp.asarray(p), reduction))


@pytest.mark.parametrize("ce_w,dice_w", [(None, None), ((0.3, 1.7), (0.8, 1.2))])
@pytest.mark.parametrize("cedice", [(1.0, 1.0), (0.5, 2.0)])
def test_cem_dice_losses(cedice, ce_w, dice_w):
    logits, t = _case(seed=7)
    args_j = (jnp.asarray(logits), jnp.asarray(t), cedice, ce_w, dice_w)
    args_t = (_t(logits), _t(t), cedice, ce_w, dice_w)
    _close(tl.cem_dice_loss(*args_t).numpy(), jl.cem_dice_loss(*args_j))
    img = tl.cem_dice_loss_image(*args_t).numpy()
    assert img.shape == (B,)
    _close(img, jl.cem_dice_loss_image(*args_j))


def test_unknown_reduction_raises():
    logits, t = _case()
    with pytest.raises(ValueError):
        tl.cross_entropy_2d(_t(logits), _t(t), reduction="avg")
    with pytest.raises(ValueError):
        tl.multiclass_mse_loss(_t(logits), _t(logits), reduction="avg")


def _empty_rule_case():
    """Images: 0 both empty; 1 prediction on an empty target; 2 target with
    an empty prediction; 3 partial overlap; 4 random."""
    rng = np.random.default_rng(8)
    fg = np.zeros((5, S, S), bool)
    fg[1, 2:6, 2:6] = True
    fg[3, 4:12, 4:12] = True
    fg[4] = rng.random((S, S)) < 0.4
    logits = np.where(fg[..., None], [[-2.0, 2.0]], [[2.0, -2.0]]).astype(np.float32)
    t = np.zeros((5, S, S), np.int32)
    t[2, 3:9, 3:9] = 1
    t[3, 6:14, 6:14] = 1
    t[4] = rng.random((S, S)) < 0.4
    return logits, t


def test_dice_vector_empty_mask_rules():
    logits, t = _empty_rule_case()
    d, counted = tm._dice_vector(_t(logits), _t(t), 0.5)
    rd, rc = jm._dice_vector(jnp.asarray(logits), jnp.asarray(t), 0.5)
    _close(d.numpy(), rd)
    np.testing.assert_array_equal(counted.numpy(), np.asarray(rc))
    assert d[0] == 1.0 and d[1] == 0.0 and d[2] == 0.0 and 0.0 < d[3] < 1.0
    assert counted.tolist()[:2] == [0, 1]


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
def test_dice_fn(threshold):
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(4, S, S, 2)).astype(np.float32)
    t = (rng.random((4, S, S)) < 0.5).astype(np.int32)
    t[0] = 0
    _close(tm.dice_fn(_t(logits), _t(t), threshold).numpy(),
           jm.dice_fn(jnp.asarray(logits), jnp.asarray(t), threshold))


def test_dice_fn_multiclass_argmax():
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(4, S, S, 3)).astype(np.float32)
    t = rng.integers(0, 3, size=(4, S, S)).astype(np.int32)
    _close(tm.dice_fn(_t(logits), _t(t)).numpy(), jm.dice_fn(jnp.asarray(logits), jnp.asarray(t)))
