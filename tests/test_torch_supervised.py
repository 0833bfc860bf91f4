"""The supervised (comparison) trainer: the port against the JAX package's.

On the CPU, f32, single-modal UNet at base width 4 and 32 px, the same
numpy inputs through both packages:
- ``make_criterion`` for ce, dice and cedice, with and without class
  weights, to rtol 1e-5;
- one supervised step from the same weights and batch: loss and dice sum to
  rtol 1e-5, the single-net eval step (on the same weights, before the
  update) to 1e-5, the updated running stats to
  1e-4, and the updated parameters under test_torch_step.py's AMSGrad
  first-step rule (every element within 1e-6 + 1e-2*lr, except elements
  whose f32 gradient sign is not determined: the conv biases that feed a
  BatchNorm and elements under 5% of their tensor's largest gradient, held
  at 2*lr, at most 5% of a tensor);
- 3 epochs of ``Trainer.run`` against the JAX trainer on a single-modal
  4-case synthetic task (lr 1e-6, see test_torch_trainer.py): history
  within rtol 1e-3 (1e-3 absolute for dice), the same best-checkpoint
  epochs, log lines equal with the time masked, and a best ``.pkl`` that
  ``torch.load(weights_only=True)`` reads, whose embedded ``history`` is
  the port's history without time keys and matches the JAX sidecar's, and
  which ``import_reference_checkpoint(path, "unet")`` reads back equal to
  the port net at that epoch.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.state import TrainState as JTrainState
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.interop import import_reference_checkpoint
from aide_tpu.models import build_model as j_build_model
from aide_tpu.ops import make_optimizer as j_make_optimizer

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as tckpt
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.engine.state import TrainState
from aide_tpu_torch.interop.weights import load_variables, variables_to_state_dict
from aide_tpu_torch.models import build_model
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
LR = 1e-4
EPOCHS = 3
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=False, num_cases=4, slices_per_case=4,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _cfgs(tmp_path=None, lr=LR):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="unet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.variant = "comparison"
    jcfg.coteach.enabled = False
    jcfg.data.img_size = S
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3  # a ragged last test batch
    jcfg.optim.lr = lr
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    if tmp_path is not None:
        jcfg.checkpoint_dir = str(tmp_path / "jckpt")
        jcfg.history_dir = str(tmp_path / "jhist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    if tmp_path is not None:
        cfg.checkpoint_dir = str(tmp_path / "ckpt")
        cfg.history_dir = str(tmp_path / "hist")
    return jcfg, cfg


def _logits_targets(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(3, 16, 16, 2)).astype(np.float32) * 2.0
    yy, xx = np.mgrid[0:16, 0:16]
    targets = np.stack([((yy - rng.uniform(4, 12)) ** 2 + (xx - rng.uniform(4, 12)) ** 2
                         <= rng.uniform(9, 30)).astype(np.int32) for _ in range(3)])
    return logits, targets


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss", ["ce", "dice", "cedice"])
def test_criterion_equals_jax(loss, weighted):
    jcfg, cfg = _cfgs()
    for c in (jcfg, cfg):
        c.optim.loss = loss
        if weighted:
            c.coteach.ceclass_weight = (0.3, 1.7)
            c.coteach.diceclass_weight = (0.6, 1.4)
            c.coteach.cedice_weight = (0.8, 1.2)
    logits, targets = _logits_targets(1)
    want = float(jsteps.make_criterion(jcfg)(jnp.asarray(logits), jnp.asarray(targets)))
    got = steps.make_criterion(cfg)(torch.from_numpy(logits), torch.from_numpy(targets).long())
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_criterion_refuses_an_unknown_loss():
    _, cfg = _cfgs()
    cfg.optim.loss = "focal"
    with pytest.raises(ValueError, match="unknown loss"):
        steps.make_criterion(cfg)


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S]
    target = np.stack([((yy - rng.uniform(8, 24)) ** 2 + (xx - rng.uniform(8, 24)) ** 2
                        <= rng.uniform(16, 80)).astype(np.int32) for _ in range(b)])
    return {
        "image": rng.integers(0, 256, size=(b, S, S, 3), dtype=np.uint8),
        "scale": rng.uniform(0.01, 0.03, size=(b, 3)).astype(np.float32),
        "fill": rng.uniform(-2.5, -0.5, size=(b, 3)).astype(np.float32),
        "target": target,
    }


@pytest.fixture(scope="module")
def one_step():
    jcfg, cfg = _cfgs()
    jmodel = j_build_model(jcfg.model)
    v = jmodel.init(jax.random.key(0), jnp.zeros((1, S, S, 3)), train=False)
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10, num_epochs=10)
    jstate = JTrainState.create(v, tx)
    jstep = jsteps.make_supervised_train_step(jmodel, False, jcfg)
    jeval = jsteps.make_eval_step(jmodel, False, jcfg, dual=False)

    net = build_model(cfg.model).to(memory_format=torch.channels_last)
    load_variables(net, _np_tree(v))
    state = TrainState(net, make_optimizer(list(net.parameters()), cfg.optim, 10, 10))
    step = steps.make_supervised_train_step(False, cfg)
    evaluate = steps.make_eval_step(False, cfg, dual=False)

    batch = _batch(4, seed=10)
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    tbatch["target"] = tbatch["target"].long()
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    # the eval step on the shared weights, before the update moves them apart
    eval_batch = _batch(3, seed=11)
    je = jeval(jstate, {k: jnp.asarray(x) for k, x in eval_batch.items()})
    te = evaluate(state, {k: torch.from_numpy(x) for k, x in eval_batch.items()})
    jstate, jm = jstep(jstate, jbatch)
    tm = step(state, tbatch)
    return dict(
        jm={k: float(x) for k, x in jm.items()}, tm={k: float(x) for k, x in tm.items()},
        je={k: float(x) for k, x in je.items()}, te={k: float(x) for k, x in te.items()},
        jvars=_np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats}),
        jmu=_np_tree(jstate.opt_state[0].mu), jbs=_np_tree(jstate.batch_stats),
        port=state,
    )


@pytest.mark.parametrize("which", ["train", "eval"])
def test_supervised_step_metrics(one_step, which):
    j, t = (one_step["jm"], one_step["tm"]) if which == "train" else (one_step["je"], one_step["te"])
    assert set(t) == set(j) == {"loss", "dice_sum", "count"}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    assert one_step["port"].step == 1


def test_supervised_step_new_params_and_stats(one_step):
    ref = variables_to_state_dict(one_step["jvars"], "unet")
    # optax's first moment after one step is (1 - b1) * grad
    grad = variables_to_state_dict(
        {"params": jax.tree_util.tree_map(lambda x: x / 0.1, one_step["jmu"]),
         "batch_stats": one_step["jbs"]}, "unet")
    got = {k: x.detach().numpy() for k, x in one_step["port"].net.state_dict().items()}
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


# ------------------------------ the epoch ------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("supervised")
    jcfg, cfg = _cfgs(tmp, lr=1e-6)
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS))
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp / "t"), **TASK_ARGS), device="cpu")
    assert not tr.dual and tr.train_pipe.labels is None and len(tr.state.nets) == 1
    load_variables(tr.state.net, _np_tree({"params": jtr.state.params,
                                           "batch_stats": jtr.state.batch_stats}))
    states = {}
    inner_epoch = tr.run_epoch

    def run_epoch(epoch):
        row = inner_epoch(epoch)
        states[epoch + 1] = {k: v.detach().clone() for k, v in tr.state.net.state_dict().items()}
        return row

    tr.run_epoch = run_epoch
    jtr.run(EPOCHS)
    tr.run(EPOCHS)
    return dict(jax=jtr, port=tr, states=states, cfg=cfg, jcfg=jcfg)


def _assert_rows_close(got, want):
    assert len(got) == len(want)
    for j, t in zip(want, got):
        assert set(t) == set(j)
        assert t["epoch"] == j["epoch"]
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")


def test_supervised_history_matches(runs):
    jh, th = runs["jax"].history, runs["port"].history
    assert len(th) == EPOCHS
    assert {"train_loss", "train_dice_sum", "test_loss", "test_dice_sum", "traincase_dice1",
            "testcase_dice1"} <= set(th[0])
    assert not any(k.endswith("2") for k in th[0])
    _assert_rows_close(th, jh)
    with open(os.path.join(runs["cfg"].history_dir,
                           f"{runs['cfg'].experiment_name}_history.json")) as fh:
        assert json.load(fh) == th


def _log_from_start(cfg, name="Start Training"):
    with open(os.path.join(cfg.history_dir, f"{cfg.experiment_name}.log")) as fh:
        lines = fh.read().splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith(name))
    return [re.sub(r"time: \d+\.\d", "time: *", line) for line in lines[start:]]


def test_supervised_log_lines_match(runs):
    want = _log_from_start(runs["jcfg"])
    got = _log_from_start(runs["cfg"])
    assert sum(line.startswith("epoch[") for line in got) == EPOCHS
    assert got == want


def test_supervised_best_export(runs):
    cfg, jcfg = runs["cfg"], runs["jcfg"]
    epochs = [int(m.group(1)) for line in _log_from_start(cfg)
              if (m := re.match(r"Best Checkpoint (\d+) Saving", line))]
    assert epochs and epochs == [int(m.group(1)) for line in _log_from_start(jcfg)
                                 if (m := re.match(r"Best Checkpoint (\d+) Saving", line))]
    path = tckpt.best_net_path(cfg.checkpoint_dir, cfg.experiment_name)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    assert obj["epoch"] == epochs[-1] and obj["traincase_dice"] == runs["port"].best_dice
    timeless = [{k: v for k, v in r.items() if not k.startswith("time")}
                for r in runs["port"].history[: epochs[-1]]]
    assert obj["history"] == timeless
    with open(path + ".json") as fh:
        assert json.load(fh)["history"] == timeless
    with open(os.path.join(jcfg.checkpoint_dir,
                           f"{jcfg.experiment_name}_besttraincasedice.msgpack.json")) as fh:
        jhist = json.load(fh)["history"]
    _assert_rows_close(obj["history"], jhist)
    got = variables_to_state_dict(_np_tree(import_reference_checkpoint(path, "unet")), "unet")
    want = runs["states"][epochs[-1]]
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.numpy()), k
    # a supervised run from that export starts from its weights
    cfg2 = TrainConfig.from_dict(cfg.to_dict())
    cfg2.resume_file = path
    cfg2.history_dir = cfg.history_dir + "_resumed"
    tr = ttrainer.Trainer(cfg2, SyntheticTask(root=cfg2.history_dir, **TASK_ARGS), device="cpu")
    for k, v in want.items():
        assert torch.equal(tr.state.net.state_dict()[k], v), k


def test_single_net_case_evaluation(runs):
    """The single-net forms of case evaluation: the whole-set and the
    per-batch inference give the same (S, H, W) volumes under net key 0, and
    scoring them against the ground truth equals the JAX package's."""
    from aide_tpu.evaluation import case_eval as jce

    from aide_tpu_torch.evaluation import case_eval as tce

    tr, jtr = runs["port"], runs["jax"]
    cases = list(tr.train_pipe.cases)
    kw = dict(batch_size=3, keep_largest_cc=True, dual=False)
    whole = tce.start_case_inference(tr.predict_step, tr.state, tr.train_pipe, cases,
                                     predict_all=tr.predict_all, **kw)()
    per_batch = tce.start_case_inference(tr.predict_step, tr.state, tr.train_pipe, cases, **kw)()
    assert len(whole) == len(per_batch) == len(cases)
    for a, b, case in zip(whole, per_batch, cases):
        assert set(a) == set(b) == {0}
        assert a[0].shape == (len(tr.train_pipe.case_indices(case)), 32, 32)
        assert np.array_equal(a[0], b[0])
    score = dict(target_net=None, full_metrics=True, keep_volumes=True)
    got = tce.score_case_volumes(tr.train_pipe, cases, whole, dual=False, **score)
    want = jce.score_case_volumes(jtr.train_pipe, cases, whole, dual=False, **score)
    assert set(got) == set(want) == {0}
    for g, w in zip(got[0], want[0]):
        assert (g.case_id, g.dice, g.iou, g.tp, g.tn, g.fp, g.fn) == (
            w.case_id, w.dice, w.iou, w.tp, w.tn, w.fp, w.fn)
