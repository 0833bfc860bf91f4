"""Exact resume from the ``_full`` / ``_last_full`` files, across the packages.

On the CPU, f32, two-modal FuseUNet at base width 4 and 32 px (the task and
schedule of tests/test_torch_epoch.py: 4 train cases x 4 slices, batch 4,
2 TTA views, refresh of 1 case a net every epoch), lr 1e-6:

(i) the port's msgpack encoder and decoder against flax's, on the JAX
    package's own state tree for every optimizer layout (amsgrad_adam, adam,
    sgd; behind clipping and decay, one of them, or neither): the port's
    bytes equal ``to_bytes``'s, flax's ``msgpack_restore`` reads them leaf
    for leaf and dtype for dtype, and the port reads ``to_bytes``'s;
(ii) JAX -> port: one JAX dual epoch (``run(1)``); the port's Trainer
    resumes from its ``_last_full`` and from its best ``_full``: every
    parameter, BN statistic, moment and count equals the file's after the
    layout moves (the port writes the file's bytes back), the bookkeeping
    equals the sidecar's and the working labels the JAX run's. Then the port's epoch 2, drawing the JAX view
    parameters, is held to the JAX trainer's own resumed epoch 2 at
    tests/test_torch_epoch.py's bars (refresh_log identical, history within
    rtol 1e-3, 1e-3 absolute for dice);
(iii) port -> JAX: the port's ``_last_full`` of that dual run, and of a
    supervised GroupNorm UNet under adam with clipping and decay, resume in
    the JAX Trainer (``aide_tpu.engine.checkpoint.load_train_state``): its
    state equals the port's leaf for leaf;
(iv) the port alone: ``run(3)`` straight against ``run(1)`` and a resumed
    ``run(3)``, dual with refresh and supervised with the ascending gate:
    the history without ``time*`` keys, the final parameters and the
    resumed epochs' refresh_log are equal bit for bit.
"""

import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, OptimConfig as JOptimConfig
from aide_tpu.core.config import TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import checkpoint as jckpt
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import schedules as jsched
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import trainer as ttrainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=True, num_cases=4, slices_per_case=4,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)
BOOKKEEPING = ("next_epoch", "best_dice", "ascending", "changepoint_dice")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
            if not v:
                out[f"{prefix}{k}/"] = None
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    """Leaf for leaf: the same paths (empty maps included), shapes, dtypes
    and values."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w)
    for k, v in w.items():
        if v is None:
            assert g[k] is None, k
            continue
        assert g[k].dtype == v.dtype and g[k].shape == v.shape, (k, g[k].dtype, v.dtype)
        assert np.array_equal(g[k], v), k


def _strip(history):
    return [{k: v for k, v in r.items() if not k.startswith("time")} for r in history]


# ------------------------------- (i) msgpack -------------------------------

LAYOUTS = [
    dict(optimizer="amsgrad_adam"), dict(optimizer="adam"), dict(optimizer="sgd"),
    dict(optimizer="amsgrad_adam", grad_clip_norm=1.0, weight_decay=1e-4),
    dict(optimizer="sgd", grad_clip_norm=1.0), dict(optimizer="adam", weight_decay=1e-4),
]


@pytest.mark.parametrize("options", LAYOUTS, ids=lambda o: "-".join(map(str, o.values())))
def test_msgpack_against_flax(options):
    rng = np.random.default_rng(0)
    params = {"Conv_0": {"kernel": rng.normal(size=(2, 3, 3, 3, 4)).astype(np.float32),
                         "bias": rng.normal(size=(2, 4)).astype(np.float32)},
              "modal1_block1": {"Norm_0": {"BatchNorm_0": {
                  "scale": rng.normal(size=(2, 4)).astype(np.float32)}}}}
    tx = jsched.make_optimizer(JOptimConfig(**options), 4, 10)
    opt_state = jax.tree_util.tree_map(
        lambda x: (jnp.asarray(rng.normal(size=x.shape), x.dtype) if x.ndim
                   else jnp.asarray(7, jnp.int32)), tx.init(params))
    state = {"step": jnp.asarray(7, jnp.int32), "params": params, "batch_stats": {},
             "opt_state": opt_state}
    data = serialization.to_bytes(state)
    mine = ckpt.msgpack_restore(data)
    _assert_trees_equal(mine, serialization.to_state_dict(jax.device_get(state)))
    assert ckpt.msgpack_pack(mine) == data
    _assert_trees_equal(serialization.msgpack_restore(ckpt.msgpack_pack(mine)), mine)


# ------------------------- the JAX run and its files -------------------------


def _cfgs(tmp, name):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3
    jcfg.data.num_tta_views = 2
    jcfg.optim.lr = 1e-6
    jcfg.coteach.warmup_epochs = 3
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir = str(tmp / name / "ckpt")
    jcfg.history_dir = str(tmp / name / "hist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    return jcfg, cfg


def _jax_views(jtr, cfg):
    def views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(key, cfg.data.num_tta_views, batch,
                                       cfg.data.rotation_degree, cfg.data.hflip_prob)
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    return views


def _copy_run(src, dst):
    """A copy of a run's directory (data with its tempmasks, exports): each
    resumed trainer writes its own refreshes and files."""
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX dual epoch, its files, and the JAX trainer's own resumed
    epoch 2 (from a copy of the run), with the port's resumed trainers built
    before that epoch writes its refresh."""
    tmp = tmp_path_factory.mktemp("resume")
    jcfg, _ = _cfgs(tmp, "run")
    jtask = JSyntheticTask(root=str(tmp / "run" / "data"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    jtr.label_cases = set(jtask.clean_case_ids())
    jtr.run(1)
    ck, prefix = jcfg.checkpoint_dir, jcfg.experiment_name
    files = {"last": os.path.join(ck, f"{prefix}_last_full.msgpack"),
             "best": os.path.join(ck, f"{prefix}_full.msgpack")}
    assert all(os.path.exists(p) and os.path.exists(p + ".json") for p in files.values())
    out = dict(jax=jtr, files=files, tmp=tmp, port={}, restored={})
    # the port resumes from copies of the run: the _last_full and the best _full
    for which, path in files.items():
        root = _copy_run(tmp / "run", tmp / f"port_{which}")
        _, cfg = _cfgs(tmp, f"port_{which}")
        cfg.resume_file = str(root / "ckpt" / os.path.basename(path))
        task = SyntheticTask(root=str(root / "data"), **TASK_ARGS)
        tr = ttrainer.Trainer(cfg, task, device="cpu")
        tr.label_cases = set(task.clean_case_ids())
        tr.view_params = _jax_views(jtr, cfg)
        out["port"][which] = tr
        out["restored"][which] = dict(
            tree=ckpt.state_tree(tr.state), count=tr.state.optimizer.count,
            bookkeeping=(tr.start_epoch, tr.best_dice, tr.ascending, tr.changepoint_dice),
            history=list(tr.history))
    # the JAX trainer's own resume from the _last_full, one more epoch
    root = _copy_run(tmp / "run", tmp / "jax_resumed")
    jcfg2, _ = _cfgs(tmp, "jax_resumed")
    jcfg2.resume_file = str(root / "ckpt" / os.path.basename(files["last"]))
    jtask2 = JSyntheticTask(root=str(root / "data"), **TASK_ARGS)
    jres = JTrainer(jcfg2, task=jtask2)
    jres.label_cases = set(jtask2.clean_case_ids())
    assert jres.start_epoch == 1
    jres.run(2)
    out["jax_resumed"] = jres
    tr = out["port"]["last"]
    out["messages"] = []
    handler = logging.Handler()
    handler.emit = lambda record: out["messages"].append(record.getMessage())
    tr.logger.addHandler(handler)
    try:
        tr.run(2)
    finally:
        tr.logger.removeHandler(handler)
    return out


@pytest.mark.parametrize("which", ["last", "best"])
def test_jax_full_file_resumes_in_the_port(jax_run, which):
    path = jax_run["files"][which]
    with open(path, "rb") as fh:
        want = serialization.msgpack_restore(fh.read())
    got = jax_run["restored"][which]
    _assert_trees_equal(got["tree"], want)
    with open(path, "rb") as fh:
        assert ckpt.msgpack_pack(got["tree"]) == fh.read()  # the JAX file's bytes
    meta = jckpt.read_meta(path)
    assert got["bookkeeping"] == tuple(meta[k] for k in BOOKKEEPING)
    assert got["bookkeeping"][0] == (1 if which == "last" else 0)
    assert got["history"] == meta["history"] and len(got["history"]) == got["bookkeeping"][0]
    assert got["count"] == int(want["step"]) == 4


@pytest.mark.parametrize("net", [1, 2])
def test_working_labels_come_back(jax_run, net):
    """The resumed port trainer read the JAX run's refreshed tempmasks."""
    tr = jax_run["port"]["best"]
    want = jax_run["jax"].train_pipe.labels.get(net)
    assert any(rewritten for *_, rewritten in jax_run["jax"].refresh_log)
    assert np.array_equal(tr.train_pipe.labels.get(net), want)


def test_resumed_epoch_matches_jax(jax_run):
    jres, tr = jax_run["jax_resumed"], jax_run["port"]["last"]
    assert tr.refresh_log == jres.refresh_log and len(tr.refresh_log) == 2
    assert len(tr.history) == len(jres.history) == 2
    assert _strip(tr.history[:1]) == _strip(jres.history[:1])
    j, t = jres.history[1], tr.history[1]
    assert set(t) == set(j) and t["epoch"] == 2
    for key in j:
        if key.startswith("time") or key == "epoch":
            continue
        atol = 1e-3 if "dice" in key else 0.0
        np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol, err_msg=key)
    messages = jax_run["messages"]
    assert messages[:2] == ["Start Training (synthetic)", "Resuming at epoch 2"]
    assert not any("bootstrap" in m for m in messages)


def test_port_last_full_resumes_in_jax(jax_run):
    """The port's dual _last_full (after its resumed epoch 2) in the JAX
    Trainer."""
    tr = jax_run["port"]["last"]
    path = ckpt.full_path(tr.cfg.checkpoint_dir, tr.cfg.experiment_name, last=True)
    jcfg, _ = _cfgs(jax_run["tmp"], "jax_from_port")
    jcfg.resume_file = path
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(jax_run["tmp"] / "port_last" / "data"),
                                             **TASK_ARGS))
    _assert_trees_equal(serialization.to_state_dict(jax.device_get(jckpt.state_tree(jtr.state))),
                        ckpt.state_tree(tr.state))
    assert jtr.start_epoch == 2 and jtr.history == jckpt.read_meta(path)["history"]
    assert jtr.best_dice == tr.best_dice


def test_port_supervised_last_full_resumes_in_jax(tmp_path):
    """A supervised GroupNorm UNet (an empty batch_stats) under adam behind
    clipping and decay: the chain {"0": {}, "1": {}, "2": adam}."""
    jcfg, _ = _cfgs(tmp_path, "sup")
    jcfg.model = JModelConfig(name="unet", base_width=4, compute_dtype="float32", norm="group")
    jcfg.data.variant = "comparison"
    jcfg.coteach.enabled = False
    jcfg.optim = JOptimConfig(lr=1e-3, optimizer="adam", grad_clip_norm=1.0, weight_decay=1e-4)
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    args = dict(TASK_ARGS, two_modal=False)
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "data"), **args), device="cpu")
    tr.run(1)
    path = ckpt.full_path(cfg.checkpoint_dir, cfg.experiment_name, last=True)
    port_tree = ckpt.state_tree(tr.state)
    assert port_tree["batch_stats"] == {} and port_tree["opt_state"]["0"] == {}
    assert sorted(port_tree["opt_state"]["2"]["0"]) == ["count", "mu", "nu"]
    jcfg.resume_file = path
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(tmp_path / "data"), **args))
    _assert_trees_equal(serialization.to_state_dict(jax.device_get(jckpt.state_tree(jtr.state))),
                        port_tree)
    assert jtr.start_epoch == 1 and int(jtr.state.step) == 4


# ------------------------------ (iv) the port alone ------------------------------


def _port_cfg(tmp, name, dual):
    _, cfg = _cfgs(tmp, name)
    cfg.optim.lr = 1e-3
    if not dual:
        cfg.model.name = "unet"
        cfg.data.variant = "comparison"
        cfg.coteach.enabled = False
        cfg.ascending_checkpoint_gate = True
        cfg.checkpoint_flush = "best"
    return cfg


@pytest.mark.parametrize("dual", [True, False], ids=["dual", "supervised"])
def test_port_resume_equals_straight_run(tmp_path, dual):
    args = dict(TASK_ARGS, two_modal=dual)
    runs = {}
    for name in ("straight", "resumed"):
        cfg = _port_cfg(tmp_path, name, dual)
        task = SyntheticTask(root=str(tmp_path / name / "data"), **args)
        tr = ttrainer.Trainer(cfg, task, device="cpu")
        tr.label_cases = set(task.clean_case_ids())
        if name == "resumed":
            tr.run(1)
            cfg.resume_file = ckpt.full_path(cfg.checkpoint_dir, cfg.experiment_name, last=True)
            tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / name / "data"), **args),
                                  device="cpu")
            tr.label_cases = set(task.clean_case_ids())
            assert tr.start_epoch == 1
        tr.run(3)
        runs[name] = tr
    a, b = runs["straight"], runs["resumed"]
    assert _strip(a.history) == _strip(b.history) and len(b.history) == 3
    if dual:
        assert b.refresh_log == a.refresh_log[2:] and len(b.refresh_log) == 4
    else:
        # the ascending gate held a changepoint and then saved a best epoch
        assert a.ascending and b.ascending and a.best_dice == b.best_dice > 0
    for na, nb in zip(a.state.nets, b.state.nets):
        for (k, x), y in zip(na.state_dict().items(), nb.state_dict().values()):
            assert torch.equal(x, y), k
    _assert_trees_equal(ckpt.state_tree(b.state), ckpt.state_tree(a.state))
