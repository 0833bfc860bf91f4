"""The main-view augmentation (data.augment_main): the port against the JAX
package's, on the CPU (both take their 3-shear path there).

- ``make_augment_batch`` on seeded uint8 batches, single- and two-modal,
  with a supervised batch's ``target`` and a dual batch's ``target``,
  ``target1`` and ``target2``, for 2 and 4 classes, each image rotated by
  the angle and flipped by the flag that the JAX augment draws from its
  key: the warped images within 1e-5; the targets equal to JAX's except at
  pixels where JAX's two largest warped class values lie within 1e-6 of
  each other and are not 0 (a tie the argmax may break either way; past
  the source every class is 0 and both give background), which must be
  under 1% of the pixels; the other keys untouched.
- 2 epochs of ``Trainer.run`` of the supervised trainer with augment_main
  against the JAX trainer, from the same weights, the port drawing the JAX
  trainer's augment parameters: the history within rtol 1e-3 (1e-3
  absolute for dice), as tests/test_torch_supervised.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import tta as jtta
from aide_tpu.ops import warp as jwarp

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.interop.weights import load_variables


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
TIE = 1e-6


def _batch(b, two_modal, targets, num_classes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for suf in (("1", "2") if two_modal else ("",)):
        out[f"modal{suf}" if suf else "image"] = rng.integers(0, 256, size=(b, S, S, 3),
                                                             dtype=np.uint8)
        out[f"scale{suf}"] = rng.uniform(0.01, 0.03, size=(b, 3)).astype(np.float32)
        out[f"fill{suf}"] = rng.uniform(-2.5, -0.5, size=(b, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in targets:
        maps = np.zeros((b, S, S), np.int32)
        for c in range(1, num_classes):
            for i in range(b):
                cy, cx, r = rng.uniform(6, 26), rng.uniform(6, 26), rng.uniform(4, 10)
                maps[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = c
        out[t] = maps
    return out


@pytest.mark.parametrize("num_classes", [2, 4])
@pytest.mark.parametrize("two_modal,targets", [
    (False, ("target",)),
    (False, ("target", "target1", "target2")),
    (True, ("target", "target1", "target2")),
])
def test_augment_batch_matches_jax(two_modal, targets, num_classes):
    b = 5
    jcfg = JTrainConfig()
    jcfg.model.num_classes = num_classes
    jcfg.data.augment_main = True
    jcfg.data.rotation_degree = 90.0  # past 45 degrees: the rot90 branch too
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    batch = _batch(b, two_modal, targets, num_classes, seed=num_classes + 10 * len(targets))
    key = jax.random.key(3)
    want = jsteps.make_augment_batch(jcfg, two_modal)({k: jnp.asarray(v) for k, v in batch.items()},
                                                      key)
    degrees, hflip = jtta.sample_view_params(key, 1, b, jcfg.data.rotation_degree,
                                             jcfg.data.hflip_prob)
    assert 0 < float(jnp.sum(hflip)) < b and float(jnp.max(jnp.abs(degrees))) > 45.0
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for t in targets:
        tbatch[t] = tbatch[t].long()
    got = steps.make_augment_batch(cfg, two_modal)(
        tbatch, torch.from_numpy(np.array(degrees[0])), torch.from_numpy(np.array(hflip[0])))
    assert set(got) == set(batch)
    for name in ("modal1", "modal2") if two_modal else ("image",):
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-5)
    for k in batch:
        if k.startswith(("scale", "fill")):
            assert torch.equal(got[k], tbatch[k])
    for t in targets:
        assert got[t].dtype == torch.int64
        onehot = jax.nn.one_hot(jnp.asarray(batch[t]), num_classes, dtype=jnp.float32)
        warped = np.sort(np.asarray(jwarp.augment(onehot, degrees[0], hflip[0], 0.0)), axis=-1)
        # pixels past the source hold 0 for every class and are background in
        # both packages: no tie there
        tie = (warped[..., -1] - warped[..., -2] <= TIE) & (warped[..., -1] > 0)
        differ = got[t].numpy() != np.asarray(want[t])
        assert not (differ & ~tie).any(), (t, int((differ & ~tie).sum()))
        assert tie.mean() < 0.01, (t, float(tie.mean()))
        # the warp moved the labels
        assert (got[t].numpy() != batch[t]).any()


TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=False, num_cases=4, slices_per_case=4,
    size=S, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)
EPOCHS = 2


def test_supervised_epochs_with_augment_match_jax(tmp_path):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="unet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.variant = "comparison"
    jcfg.coteach.enabled = False
    jcfg.data.img_size = S
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3
    jcfg.data.augment_main = True
    jcfg.optim.lr = 1e-6
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir = str(tmp_path / "jckpt")
    jcfg.history_dir = str(tmp_path / "jhist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.history_dir = str(tmp_path / "hist")
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(tmp_path / "j"), **TASK_ARGS))
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
    load_variables(tr.state.net, jax.tree_util.tree_map(
        np.asarray, {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))
    drawn = []

    def jax_augment(epoch, step, b):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), 1_000_000 + step)
        d, h = jtta.sample_view_params(key, 1, b, cfg.data.rotation_degree, cfg.data.hflip_prob)
        drawn.append((epoch, step))
        return torch.from_numpy(np.array(d[0])), torch.from_numpy(np.array(h[0]))

    # the port's own draw: a (B,) pair from (seed, epoch, 1_000_000 + step)
    d, h = tr.augment_params(0, 0, 4)
    assert d.shape == h.shape == (4,) and torch.equal(d, tr.augment_params(0, 0, 4)[0])
    assert not torch.equal(d, tr.augment_params(0, 1, 4)[0])
    tr.augment_params = jax_augment
    jtr.run(EPOCHS)
    tr.run(EPOCHS)
    spe = tr.train_pipe.steps_per_epoch(4)
    assert drawn == [(e, s) for e in range(EPOCHS) for s in range(spe)]
    jh, th = jtr.history, tr.history
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")
