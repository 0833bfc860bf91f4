"""The rest of the JAX op library in the port: losses, metrics and the
co-teaching variants, against aide_tpu.ops on the same seeded inputs.

One parametrised test per module. Inputs: binary logits (4, 13, 10, 2)
(13 rows, so the region pooling has a partial window), 3-class logits and
one-hot targets for the multiclass metrics, and (2, 5, 6, 4) volumes for
the 3D metrics. Values are held at rtol 1e-5, atol 1e-6 (f32 sums in
another order); the co-teaching variants' gradients in the last net's
logits (net 3's for the three-model variant, whose loss is net 3's) at
rtol 1e-4, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.ops import coteach as jcoteach
from aide_tpu.ops import losses as jlosses
from aide_tpu.ops import metrics as jmetrics

from aide_tpu_torch.ops import coteach, losses, metrics


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    shape = (4, 13, 10)
    logits = [(2.0 * rng.normal(size=shape + (2,))).astype(np.float32) for _ in range(3)]
    targets = (rng.random(shape) < 0.4).astype(np.int32)
    targets[1] = 0  # an image without foreground
    probs = rng.random(shape).astype(np.float32)
    logits3 = rng.normal(size=shape + (3,)).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=shape)]
    vols = (rng.random((2, 5, 6, 4)) < 0.3).astype(np.uint8)
    return dict(logits=logits, targets=targets, probs=probs, logits3=logits3, onehot=onehot,
                vols=vols)


def _compare(got, want, rtol=RTOL, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


def _both(fn_t, fn_j, *arrays, **kw):
    return (fn_t(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw),
            fn_j(*[jnp.asarray(a) for a in arrays], **kw))


LOSS_CASES = {
    "dice_loss_logits": lambda x: ("dice_loss", (x["logits"][0], x["targets"]), {}),
    "dice_loss_probs_none": lambda x: ("dice_loss", (x["probs"], x["targets"]),
                                       {"reduction": "none"}),
    "ce_dice_loss": lambda x: ("ce_dice_loss", (x["logits"][0], x["targets"]),
                               {"cedice_weight": (0.7, 1.3), "class_weight": (0.3, 1.0)}),
    "binary_cross_entropy_2d": lambda x: ("binary_cross_entropy_2d",
                                          (x["logits"][0], x["targets"]), {}),
    "binary_cross_entropy_2d_mean": lambda x: ("binary_cross_entropy_2d",
                                               (x["logits"][0], x["targets"]),
                                               {"reduction": "mean"}),
    "focal_loss": lambda x: ("focal_loss", (x["logits"][0], x["targets"]),
                             {"weight1": 0.5, "weight2": 2.0, "beta": 2.0}),
    "focal_loss_none": lambda x: ("focal_loss", (x["logits"][1], x["targets"]),
                                  {"beta": 1.5, "reduction": "none"}),
    "kl_bidirectional": lambda x: ("kl_bidirectional", (x["logits"][0], x["logits"][1]), {}),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case):
    name, args, kw = LOSS_CASES[case](_inputs())
    got, want = _both(getattr(losses, name), getattr(jlosses, name), *args, **kw)
    _compare(got, want)


METRIC_CASES = {
    "dice_fn_nozero": lambda x: ("dice_fn_nozero", (x["logits"][0], x["targets"]), {}),
    "iou_fn": lambda x: ("iou_fn", (x["logits"][0], x["targets"]), {"threshold": 0.4}),
    "iou_fn_c3": lambda x: ("iou_fn", (x["logits3"], x["targets"]), {}),
    "tp_tn_fp_fn": lambda x: ("tp_tn_fp_fn", (x["logits"][1], x["targets"]), {}),
    "multiclass_dice_fn": lambda x: ("multiclass_dice_fn", (x["logits3"], x["onehot"]), {}),
    "multiclass_iou_fn": lambda x: ("multiclass_iou_fn", (x["logits3"], x["onehot"]), {}),
    "multiclass_accuracy_fn": lambda x: ("multiclass_accuracy_fn",
                                         (x["logits3"], x["onehot"]), {}),
    "multiclass_tp_tn_fp_fn": lambda x: ("multiclass_tp_tn_fp_fn",
                                         (x["logits3"], x["onehot"]), {}),
    "dice3d": lambda x: ("dice3d", (x["vols"][0], x["vols"][1]), {}),
    "dice3d_empty": lambda x: ("dice3d", (0 * x["vols"][0], 0 * x["vols"][1]), {}),
    "iou3d": lambda x: ("iou3d", (x["vols"][0], x["vols"][1]), {}),
    "tp_tn_fp_fn_3d": lambda x: ("tp_tn_fp_fn_3d", (x["vols"][0], x["vols"][1]), {}),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_match_jax(case):
    name, args, kw = METRIC_CASES[case](_inputs())
    got, want = _both(getattr(metrics, name), getattr(jmetrics, name), *args, **kw)
    _compare(got, want)


COTEACH_CASES = {
    "coteach_drop_image": ("coteach_drop_image", 2, {"forget_rate": 0.5, "weight": 0.8}),
    "coteach_weight_image": ("coteach_weight_image", 2,
                             {"forget_rate": 0.25, "drop_weight": 0.2}),
    "coteach_drop_region_ce": ("coteach_drop_region_ce", 2, {"forget_rate": 0.3}),
    "coteach_drop_region_ce_third": ("coteach_drop_region_ce", 2,
                                     {"forget_rate": 0.2, "scale": 0.34}),
    "coteach_drop_image_drop_pixel": ("coteach_drop_image_drop_pixel", 2,
                                      {"forget_rate": 0.5, "pixel_weight": 0.5}),
    "pixel_coreg_focal": ("pixel_coreg_focal", 3, {"forget_rate": 0.2, "kd_weight": 0.3}),
    "pixel_coreg_focal_two_model": ("pixel_coreg_focal_two_model", 2,
                                    {"forget_rate": 0.2, "kd_weight": 0.3}),
}


@pytest.mark.parametrize("case", sorted(COTEACH_CASES))
def test_coteach_matches_jax(case):
    """Each variant's two outputs, and the gradient of their sum in the
    last net's logits."""
    name, nets, kw = COTEACH_CASES[case]
    x = _inputs()
    logits, targets = x["logits"][:nets], x["targets"]
    tl = [torch.from_numpy(a).requires_grad_(True) for a in logits]
    got = getattr(coteach, name)(*tl, torch.from_numpy(targets), **kw)
    jfn = getattr(jcoteach, name)

    def total(last):
        out = jfn(*[jnp.asarray(a) for a in logits[:-1]], last, jnp.asarray(targets), **kw)
        return out[0] + out[1], out

    (_, want), jgrad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(logits[-1]))
    _compare(got, want)
    (got[0] + got[1]).backward()
    _compare(tl[-1].grad, jgrad, rtol=1e-4, atol=1e-6)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0


def test_coteach_rejects_forgetting_everything():
    x = _inputs()
    with pytest.raises(ValueError, match="at least one"):
        coteach.coteach_drop_image(*(torch.from_numpy(a) for a in x["logits"][:2]),
                                   torch.from_numpy(x["targets"]), forget_rate=1.0)
