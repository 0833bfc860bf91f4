"""Warm start of the co-teaching pair from one net's export, and the run it begins.

On the CPU, single-modal UNet at base width 4, 32 px, f32:
- with ``warm_start_noise`` 0 both nets equal the export, BN stats included;
- with 1e-3, each parameter leaf of at least 1,000 elements moves by noise
  whose std is within 20% of 1e-3 times the leaf's population std, the two
  nets differ, the BN stats are the export's, and the same seed gives the
  same nets;
- ``Trainer.run(2)`` of a warm-started dual run against the JAX package's,
  both from the JAX warm start's noisy weights (loaded into the port through
  ``interop.weights``) and with the port drawing the JAX run's view
  parameters: the bootstrap skill probe runs before the first train step
  and equals the JAX probe within 1e-3; ``refresh_log`` is identical, and
  the JAX run's dice gap at each worst-k boundary is wider than the
  largest case-dice difference between the packages;
- a ``_full.msgpack`` or ``_last_full.msgpack`` resume file is an exact
  resume and never a warm start: the pair comes back as saved, without
  noise, and a missing one raises.
"""

import jax
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import checkpoint as jckpt
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.models import build_model as j_build_model
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as tckpt
from aide_tpu_torch.engine import trainer as ttrainer
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


EPOCHS = 2
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=False, num_cases=4, slices_per_case=4,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _cfgs(tmp_path, resume):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="unet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3
    jcfg.data.num_tta_views = 2
    jcfg.data.rotation_degree = 60.0
    jcfg.optim.lr = 1e-6
    jcfg.coteach.warmup_epochs = 3  # both epochs refresh
    jcfg.coteach.sharpen_mode = "pow_inv_t"
    jcfg.coteach.refresh_skip_empty = True
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    jcfg.resume_file = resume["jax"]
    jcfg.checkpoint_dir = str(tmp_path / "jckpt")
    jcfg.history_dir = str(tmp_path / "jhist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    cfg.resume_file = resume["port"]
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.history_dir = str(tmp_path / "hist")
    return jcfg, cfg


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """One UNet's weights, exported by each package: the JAX package's
    msgpack and the port's AIDE-layout .pkl, with moved BN stats."""
    tmp = tmp_path_factory.mktemp("exports")
    jm = j_build_model(JModelConfig(name="unet", base_width=4, compute_dtype="float32"))
    v = _np_tree(jm.init(jax.random.key(5), np.zeros((1, 32, 32, 3), np.float32), train=False))
    rng = np.random.default_rng(6)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + 0.1 * np.abs(rng.normal(size=x.shape))).astype(np.float32), v["batch_stats"])
    sd = {k: torch.from_numpy(x) for k, x in variables_to_state_dict(v, "unet").items()}
    paths = {"jax": str(tmp / "src_besttraincasedice.msgpack"),
             "port": str(tmp / "src_besttraincasedice.pkl")}
    jckpt.save_net(paths["jax"], v, {"epoch": 1})
    torch.save({"net": sd, "epoch": 1, "traincase_dice": 0.5}, paths["port"])
    return dict(paths=paths, sd=sd, tmp=tmp)


def _port_trainer(exports, tmp_path, noise, seed=2):
    _, cfg = _cfgs(tmp_path, exports["paths"])
    cfg.coteach.warm_start_noise = noise
    cfg.seed = seed
    return ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")


def test_warm_start_without_noise_copies_the_export(exports, tmp_path):
    tr = _port_trainer(exports, tmp_path, noise=0.0)
    assert tr.dual and len(tr.state.nets) == 2
    for net in tr.state.nets:
        sd = net.state_dict()
        assert set(sd) == set(exports["sd"])
        for k, want in exports["sd"].items():
            assert torch.equal(sd[k], want), k


def test_warm_start_noise_scale(exports, tmp_path):
    tr = _port_trainer(exports, tmp_path, noise=1e-3)
    nets = tr.state.nets
    checked = 0
    for name, _ in nets[0].named_parameters():
        src = exports["sd"][name]
        if src.numel() < 1000:
            continue
        want = 1e-3 * float(src.std(correction=0))
        for net in nets:
            diff = net.get_parameter(name).detach() - src
            assert abs(float(diff.std()) / want - 1.0) < 0.2, (name, float(diff.std()), want)
        checked += 1
        assert not torch.equal(nets[0].get_parameter(name), nets[1].get_parameter(name))
    assert checked >= 5
    for net in nets:
        for k, buf in net.named_buffers():
            assert torch.equal(buf, exports["sd"][k]), k
    # the noise comes from cfg.seed's generator: the same seed, the same nets
    again = _port_trainer(exports, tmp_path / "again", noise=1e-3)
    other = _port_trainer(exports, tmp_path / "other", noise=1e-3, seed=3)
    for a, b, c in zip(nets, again.state.nets, other.state.nets):
        for (k, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
            assert torch.equal(x, y), k
        assert not all(torch.equal(x, z) for x, z in zip(a.parameters(), c.parameters()))


def test_trainer_refuses_a_full_resume_file(exports, tmp_path):
    warm = _port_trainer(exports, tmp_path / "warm", noise=1e-3)
    _, cfg = _cfgs(tmp_path, exports["paths"])
    cfg.coteach.warm_start_noise = 1e-3
    for name in ("x_full.msgpack", "x_last_full.msgpack"):
        cfg.resume_file = str(tmp_path / name)
        with pytest.raises(FileNotFoundError, match=name):
            ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
        tckpt.save_train_state(cfg.resume_file, warm.state, {"next_epoch": 1})
        tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
        assert tr.start_epoch == 1
        for a, b in zip(tr.state.nets, warm.state.nets):
            for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
                assert torch.equal(x, y), k


def _record_case_dice(trainer, log):
    inner = trainer._refresh_labels

    def refresh(epoch, traincase):
        log[epoch] = {n: {r.case_id: r.dice for r in traincase[n]} for n in traincase}
        return inner(epoch, traincase)

    trainer._refresh_labels = refresh


@pytest.fixture(scope="module")
def runs(exports):
    tmp = exports["tmp"] / "runs"
    jcfg, cfg = _cfgs(tmp, exports["paths"])
    jtask = JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS)
    task = SyntheticTask(root=str(tmp / "t"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    tr = ttrainer.Trainer(cfg, task, device="cpu")
    jtr.label_cases = set(jtask.clean_case_ids())
    tr.label_cases = set(task.clean_case_ids())
    # the JAX warm start's noisy weights in the port's nets
    for n, net in enumerate(tr.state.nets):
        load_variables(net, _np_tree(jtr.state.net_variables(n)))

    def jax_views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(
            key, cfg.data.num_tta_views, batch, cfg.data.rotation_degree, cfg.data.hflip_prob
        )
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    tr.view_params = jax_views
    events = []
    inner_probe, inner_step = tr._bootstrap_skill_probe, tr.train_step

    def probe():
        events.append(("probe", tr.state.step))
        return inner_probe()

    def step(*args):
        events.append(("step", tr.state.step))
        return inner_step(*args)

    tr._bootstrap_skill_probe, tr.train_step = probe, step
    case_dice = {"jax": {}, "port": {}}
    _record_case_dice(jtr, case_dice["jax"])
    _record_case_dice(tr, case_dice["port"])
    jtr.run(EPOCHS)
    tr.run(EPOCHS)
    return dict(jax=jtr, port=tr, case_dice=case_dice, events=events, cfg=cfg)


def test_bootstrap_probe_runs_first_and_matches_jax(runs):
    events = runs["events"]
    assert events[0] == ("probe", 0)
    spe = runs["port"].train_pipe.steps_per_epoch(runs["cfg"].data.batch_size)
    assert [e for e, _ in events].count("probe") == 1 and len(events) == 1 + spe * EPOCHS
    want, got = runs["jax"].engagement_probe, runs["port"].engagement_probe
    assert set(got) == set(want) == {"bootstrap_skill1", "bootstrap_skill2"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


def test_warm_started_refresh_log_identical_with_a_margin(runs):
    jlog, tlog = runs["jax"].refresh_log, runs["port"].refresh_log
    assert len(tlog) == 2 * EPOCHS and tlog == jlog
    assert any(rewritten for *_, rewritten in tlog)
    k = int(runs["cfg"].coteach.update_percent * len(runs["port"].train_cases))
    jd, td = runs["case_dice"]["jax"], runs["case_dice"]["port"]
    assert sorted(jd) == sorted(td) == list(range(EPOCHS))
    for epoch in jd:
        for net in (0, 1):
            j, t = jd[epoch][net], td[epoch][net]
            worst = sorted(j.values())
            gap = worst[k] - worst[k - 1]
            diff = max(abs(j[c] - t[c]) for c in j)
            assert gap > diff, (epoch, net, gap, diff)
    for net in (1, 2):
        assert np.array_equal(runs["port"].train_pipe.labels.get(net),
                              runs["jax"].train_pipe.labels.get(net))


def test_warm_started_history_matches(runs):
    jh, th = runs["jax"].history, runs["port"].history
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")
