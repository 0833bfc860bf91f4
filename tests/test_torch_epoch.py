"""The whole co-teaching epoch: the port's Trainer.run against the JAX package's.

Both trainers run 3 epochs of ``run`` on one tiny two-modal synthetic task
(4 train cases x 4 slices, 1 test case, 32 px, batch 4, eval batch 3, 2 TTA
views, FuseUNet base width 4, f32, lr 1e-6, warmup 3, the clean case
labeled), from the same weights, with the port drawing the JAX trainer's
view parameters. Every epoch refreshes the worst int(0.25 * 4) = 1 case per
net, and epoch 3 ends the ramp, so the engagement verdict runs. The bars:
- identical ``refresh_log``, and the JAX run's dice gap between the worst
  and the next case of each refresh wider than the port's largest case-dice
  difference (so that an identical selection is not luck);
- working labels that agree with Dice >= 0.995 per net;
- every history metric within rtol 1e-3 (1e-3 absolute for dice values);
- the same engagement verdict (booleans equal, floats within 1e-3);
- the same best-checkpoint epochs, and a best ``.pkl`` that the JAX
  package's ``import_reference_checkpoint`` reads back equal to the port
  net's state at that epoch;
- the same log lines from "Start Training" on, with the time field masked,
  the step-loss lines of ``log_every_steps=2`` among them.

Also: the run's ``_last_full`` file resumes a new trainer at its end (a
missing ``_full`` file raises rather than warm-starting), the trainer
takes any checkpoint flush, and refuses the net and space mesh axes and a
data axis asked of a process that ``launch`` did not start, and
a refresh runs and reads back its tempmasks where Pillow cannot be imported.
"""

import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.interop import import_reference_checkpoint
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as tckpt
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.evaluation.case_eval import dice3d_np
from aide_tpu_torch.interop.weights import load_variables, variables_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=True, num_cases=4, slices_per_case=4,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


def _cfgs(tmp_path):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3  # a ragged last row in every case pass
    jcfg.data.num_tta_views = 2
    jcfg.optim.lr = 1e-6
    jcfg.coteach.warmup_epochs = EPOCHS
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    jcfg.log_every_steps = 2
    jcfg.checkpoint_dir = str(tmp_path / "jckpt")
    jcfg.history_dir = str(tmp_path / "jhist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.history_dir = str(tmp_path / "hist")
    return jcfg, cfg


def _record_case_dice(trainer, log):
    """Record each refresh's per-net case dice, then refresh as before."""
    inner = trainer._refresh_labels

    def refresh(epoch, traincase):
        log[epoch] = {n: {r.case_id: r.dice for r in traincase[n]} for n in traincase}
        return inner(epoch, traincase)

    trainer._refresh_labels = refresh


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("epoch")
    jcfg, cfg = _cfgs(tmp)
    jtask = JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS)
    task = SyntheticTask(root=str(tmp / "t"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    tr = ttrainer.Trainer(cfg, task, device="cpu")
    jtr.label_cases = set(jtask.clean_case_ids())
    tr.label_cases = set(task.clean_case_ids())
    for n, net in enumerate(tr.state.nets):
        load_variables(net, jax.tree_util.tree_map(np.asarray, jtr.state.net_variables(n)))

    def jax_views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(
            key, cfg.data.num_tta_views, batch, cfg.data.rotation_degree, cfg.data.hflip_prob
        )
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    tr.view_params = jax_views
    case_dice = {"jax": {}, "port": {}}
    _record_case_dice(jtr, case_dice["jax"])
    _record_case_dice(tr, case_dice["port"])
    # the port nets' state after each epoch (the gate saves before the
    # refresh, which leaves the weights alone)
    states = {}
    inner_epoch = tr.run_epoch

    def run_epoch(epoch):
        row = inner_epoch(epoch)
        states[epoch + 1] = [
            {k: v.detach().clone() for k, v in net.state_dict().items()} for net in tr.state.nets
        ]
        return row

    tr.run_epoch = run_epoch
    jtr.run(EPOCHS)
    tr.run(EPOCHS)
    return dict(jax=jtr, port=tr, case_dice=case_dice, states=states, cfg=cfg, jcfg=jcfg)


def test_refresh_log_identical(runs):
    jlog, tlog = runs["jax"].refresh_log, runs["port"].refresh_log
    assert len(tlog) == 2 * EPOCHS
    assert tlog == jlog
    # not every selection is the labeled case, so labels were rewritten
    assert any(rewritten for *_, rewritten in tlog)


def test_refresh_selection_has_a_margin(runs):
    """The worst-k boundary on the JAX side is wider than any case-dice
    difference between the packages: an identical selection is implied by
    the tolerance, not luck."""
    k = int(runs["cfg"].coteach.update_percent * len(runs["port"].train_cases))
    jd, td = runs["case_dice"]["jax"], runs["case_dice"]["port"]
    assert sorted(jd) == sorted(td) == list(range(EPOCHS))
    for epoch in jd:
        for net in (0, 1):
            j, t = jd[epoch][net], td[epoch][net]
            assert set(j) == set(t)
            worst = sorted(j.values())
            gap = worst[k] - worst[k - 1]
            diff = max(abs(j[c] - t[c]) for c in j)
            assert gap > diff, (epoch, net, gap, diff)


@pytest.mark.parametrize("net", [1, 2])
def test_working_labels_agree(runs, net):
    got = runs["port"].train_pipe.labels.get(net)
    want = runs["jax"].train_pipe.labels.get(net)
    assert dice3d_np(got, want) >= 0.995
    # the device copy was synced with the host's
    assert np.array_equal(runs["port"].train_pipe._device_labels[f"target{net}"].numpy(), got)


def test_history_metrics_match(runs):
    jh, th = runs["jax"].history, runs["port"].history
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        assert t["epoch"] == j["epoch"]
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")
    with open(os.path.join(runs["cfg"].history_dir,
                           f"{runs['cfg'].experiment_name}_history.json")) as fh:
        assert json.load(fh) == th


def test_engagement_verdict_matches(runs):
    j, t = runs["jax"].engagement, runs["port"].engagement
    assert j is not None and t is not None and set(t) == set(j)
    for key, want in j.items():
        if isinstance(want, (bool, str)):
            assert t[key] == want, key
        else:
            np.testing.assert_allclose(t[key], want, atol=1e-3, err_msg=key)


def _log_from_start(cfg, name="Start Training"):
    with open(os.path.join(cfg.history_dir, f"{cfg.experiment_name}.log")) as fh:
        lines = fh.read().splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith(name))
    return [re.sub(r"time: \d+\.\d", "time: *", line) for line in lines[start:]]


def test_log_lines_match(runs):
    want = _log_from_start(runs["jcfg"])
    got = _log_from_start(runs["cfg"])
    assert sum(line.startswith("epoch[") for line in got) == 2 * EPOCHS
    assert got == want


def test_step_log_lines_match(runs):
    """log_every_steps=2: every second step of the 4 an epoch logs its
    losses, as the JAX trainer does."""
    want = [line for line in _log_from_start(runs["jcfg"]) if line.startswith("epoch ")]
    got = [line for line in _log_from_start(runs["cfg"]) if line.startswith("epoch ")]
    assert [line.split(" |")[0] for line in got] == [
        f"epoch {e} step {s}" for e in range(1, EPOCHS + 1) for s in (2, 4)]
    assert got == want


def test_best_checkpoint_epochs_and_export(runs):
    def best_epochs(cfg):
        return [int(m.group(1)) for line in _log_from_start(cfg)
                if (m := re.match(r"Best Checkpoint (\d+) Saving", line))]

    epochs = best_epochs(runs["cfg"])
    assert epochs and epochs == best_epochs(runs["jcfg"])
    cfg = runs["cfg"]
    for net in (1, 2):
        path = tckpt.best_net_path(cfg.checkpoint_dir, cfg.experiment_name, net)
        with open(path + ".json") as fh:
            meta = json.load(fh)
        assert meta["epoch"] == epochs[-1] and meta["net"] == net
        assert meta["traincase_dice"] == runs["port"].best_dice
        variables = import_reference_checkpoint(path, "fuseunet")
        got = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))
        want = runs["states"][epochs[-1]][net - 1]
        assert set(got) == set(want)
        for k, v in want.items():
            assert np.array_equal(got[k], v.numpy()), k


def test_host_batches_take_the_unfused_path_to_the_same_epoch(tmp_path):
    """device_cache='off' runs the separate test pass and the per-batch
    predict path; it gives the same epochs as the device-resident trainer's
    fused pass."""
    _, cfg = _cfgs(tmp_path)
    out = {}
    for cache in ("auto", "off"):
        cfg.data.device_cache = cache
        cfg.history_dir = str(tmp_path / cache)
        task = SyntheticTask(root=str(tmp_path / cache), **TASK_ARGS)
        tr = ttrainer.Trainer(cfg, task, device="cpu")
        assert (tr._dispatch_fused_test() is None) == (cache == "off")
        # both trainers initialise their nets from cfg.seed and draw their
        # views from (seed, epoch, step)
        out[cache] = (tr, [tr.run_epoch(e) for e in range(2)])
    (dev, dev_rows), (host, host_rows) = out["auto"], out["off"]
    assert host.refresh_log == dev.refresh_log
    for d, h in zip(dev_rows, host_rows):
        for key, v in d.items():
            if not key.startswith("time"):
                np.testing.assert_allclose(h[key], v, rtol=1e-5, atol=1e-6, err_msg=key)
    for net in (1, 2):
        assert np.array_equal(host.train_pipe.labels.get(net), dev.train_pipe.labels.get(net))


def test_trainer_refuses_a_resume_file(runs, tmp_path):
    """A ``_full`` resume file is an exact resume, never a warm start: one
    that does not exist raises; the run's ``_last_full`` gives a trainer
    at its end (tests/test_torch_resume.py holds the resume to the JAX
    package's and to an uninterrupted run)."""
    _, cfg = _cfgs(tmp_path)
    cfg.resume_file = str(tmp_path / "x_full.msgpack")
    with pytest.raises(FileNotFoundError, match="x_full.msgpack"):
        ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
    done = runs["cfg"]
    cfg.resume_file = tckpt.full_path(done.checkpoint_dir, done.experiment_name, last=True)
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
    assert tr.start_epoch == EPOCHS and tr.history == runs["port"].history
    assert tr.best_dice == runs["port"].best_dice
    assert tr.state.optimizer.count == runs["port"].state.optimizer.count == 4 * EPOCHS
    for net, want in zip(tr.state.nets, runs["states"][EPOCHS]):
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k]), k


def test_trainer_refuses_an_unknown_checkpoint_flush(tmp_path):
    """No checkpoint_flush is refused: the JAX trainer reads every value
    but "best" as "end" (``aide_tpu/engine/trainer.py:824``), and so does
    the port, which once refused them; a best epoch under "never" keeps
    its snapshot for the flush, as under "end"
    (tests/test_torch_registry_native.py holds the files to "end"'s)."""
    _, cfg = _cfgs(tmp_path)
    cfg.checkpoint_flush = "never"
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
    assert tr._maybe_checkpoint(0, 0.5, {}, {}) is True
    assert tr._best_snapshot is not None


@pytest.mark.parametrize("setting", [
    ("extra_axes", (("net", 2),)), ("extra_axes", (("space", 2),)), ("num_devices", 2),
])
def test_trainer_refuses_mesh_settings(tmp_path, setting):
    """Mesh settings the trainer cannot honour raise instead of being
    ignored: a net axis, a space axis or a data axis of two ranks asked of
    a process that ``launch`` did not start (a batch of 4 and an eval batch
    of 4 shard over 2)."""
    _, cfg = _cfgs(tmp_path)
    setattr(cfg.mesh, *setting)
    cfg.data.eval_batch_size = 4
    task = SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS)
    if setting[0] == "extra_axes":
        axis = setting[1][0][0]
        with pytest.raises(ValueError,
                           match=rf"mesh.extra_axes=\(\('{axis}', 2\),\).*mesh.launch"):
            ttrainer.Trainer(cfg, task, device="cpu")
    else:
        with pytest.raises(ValueError, match="mesh.num_devices=2.*mesh.launch"):
            ttrainer.Trainer(cfg, task, device="cpu")


def test_refresh_without_pillow(tmp_path):
    """One epoch with a refresh and checkpoint_flush='best' where PIL cannot
    be imported; the tempmasks it wrote read back as the working labels."""
    code = f"""
import sys
sys.modules['PIL'] = None
import torch
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine.trainer import Trainer
cfg = TrainConfig.from_json({TrainConfig().to_json()!r})
cfg.model.base_width = 4
cfg.model.compute_dtype = 'float32'
cfg.data.img_size = 32
cfg.data.batch_size = 4
cfg.data.num_tta_views = 2
cfg.checkpoint_flush = 'best'
cfg.checkpoint_dir = {str(tmp_path / 'ckpt')!r}
cfg.history_dir = {str(tmp_path / 'hist')!r}
task = SyntheticTask(root={str(tmp_path / 'data')!r}, **{TASK_ARGS!r})
tr = Trainer(cfg, task, device='cpu')
tr.run(1)
rewritten = [c for *_, done in tr.refresh_log for c in done]
assert rewritten, tr.refresh_log
fresh = SlicePipeline(task, task.load_manifest('', train=True), 32, working_labels=True)
for net in (1, 2):
    assert (fresh.labels.get(net) == tr.train_pipe.labels.get(net)).all()
for net in (1, 2):
    torch.load({str(tmp_path / 'ckpt')!r} + f'/{{cfg.experiment_name}}_net{{net}}_besttraincasedice.pkl')
assert 'PIL' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]
"""
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
