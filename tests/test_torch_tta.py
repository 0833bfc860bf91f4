"""The port's TTA machinery against aide_tpu.ops.tta, at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core import prng
from aide_tpu_torch.ops import tta


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


V, B, S = 3, 4, 32


def _views(seed=0):
    rng = np.random.default_rng(seed)
    degrees = rng.uniform(-60, 60, size=(V, B)).astype(np.float32)
    hflip = (rng.random((V, B)) < 0.5).astype(np.float32)
    return degrees, hflip


def _probs(c, seed=0, shape=(B, S, S)):
    rng = np.random.default_rng(seed)
    p = rng.random(shape + (c,)).astype(np.float32) + 0.05
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("fill_kind", ["scalar", "image"])
def test_make_views(fill_kind):
    rng = np.random.default_rng(1)
    images = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    fill = np.float32(-1.5) if fill_kind == "scalar" else rng.normal(size=(B, 3)).astype(np.float32)
    degrees, hflip = _views(1)
    ref = np.asarray(jtta.make_views(jnp.asarray(images), jnp.asarray(degrees), jnp.asarray(hflip),
                                     jnp.asarray(fill), method="shear"))
    out = tta.make_views(torch.from_numpy(images), torch.from_numpy(degrees),
                         torch.from_numpy(hflip), torch.as_tensor(fill)).numpy()
    assert out.shape == (V, B, S, S, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [2, 3])
def test_invert_views(c):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(V, B, S, S, c)).astype(np.float32)
    degrees, hflip = _views(2)
    ref = np.asarray(jtta.invert_views(jnp.asarray(logits), jnp.asarray(degrees),
                                       jnp.asarray(hflip), method="shear"))
    out = tta.invert_views(torch.from_numpy(logits), torch.from_numpy(degrees),
                           torch.from_numpy(hflip)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["pow_t", "pow_inv_t"])
@pytest.mark.parametrize("temperature", [1.0, 0.5, 2.0])
def test_sharpen(mode, temperature):
    p = _probs(2, seed=3)
    ref = np.asarray(jtta.sharpen(jnp.asarray(p), temperature, mode))
    out = tta.sharpen(torch.from_numpy(p), temperature, mode).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_sharpen_unknown_mode_raises():
    with pytest.raises(ValueError):
        tta.sharpen(torch.ones(2, 2), 1.0, "pow")


@pytest.mark.parametrize("c", [2, 3])
def test_confidence_weightmap(c):
    p = _probs(c, seed=4)
    ref = np.asarray(jtta.confidence_weightmap(jnp.asarray(p)))
    out = tta.confidence_weightmap(torch.from_numpy(p)).numpy()
    assert out.shape == p.shape[:-1] + (1,)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c,mode,temperature", [(2, "pow_t", 1.0), (2, "pow_inv_t", 0.5), (3, "pow_t", 2.0)])
def test_ensemble_pseudo_labels(c, mode, temperature):
    rng = np.random.default_rng(5)
    logits = (3.0 * rng.normal(size=(V, B, S, S, c))).astype(np.float32)
    degrees, hflip = _views(5)
    rp, rw = jtta.ensemble_pseudo_labels(jnp.asarray(logits), jnp.asarray(degrees),
                                         jnp.asarray(hflip), temperature, mode, method="shear")
    tp, tw = tta.ensemble_pseudo_labels(torch.from_numpy(logits), torch.from_numpy(degrees),
                                        torch.from_numpy(hflip), temperature, mode)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), rtol=1e-5, atol=1e-6)


def test_sample_view_params_distribution_and_determinism():
    draw = lambda: tta.sample_view_params(prng.generator("cpu", 2, 1, 7), 4, 4096, 60.0, 0.5)
    degrees, hflip = draw()
    assert degrees.shape == hflip.shape == (4, 4096)
    assert float(degrees.min()) >= -60.0 and float(degrees.max()) <= 60.0
    assert abs(float(degrees.mean())) < 2.0 and abs(float(degrees.std()) - 60.0 / 3 ** 0.5) < 1.0
    assert set(hflip.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(hflip.mean()) - 0.5) < 0.02
    again = draw()
    assert torch.equal(degrees, again[0]) and torch.equal(hflip, again[1])
    other = tta.sample_view_params(prng.generator("cpu", 2, 1, 8), 4, 4096, 60.0, 0.5)
    assert not torch.equal(degrees, other[0])
