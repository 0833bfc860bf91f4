"""The port's net axis (``mesh.extra_axes = (("net", 2),)``) on gloo CPU
ranks, against one process and against the JAX package's net axis on the
conftest's virtual CPU mesh.

The ranks run the programs of ``aide_tpu_torch.core.rank_checks``, spawned
through ``mesh.launch`` (so they import neither JAX nor this file), once a
layout for the unit checks and once a layout for the trainer job: net 2 on
two ranks, and data 2 x net 2 on four. Each rank uses one torch thread. The
inputs are NumPy arrays from a seed; FuseUNet of base width 4 at 16 px,
batch 8, 2 views, f32.

- the layout: rank r is data shard r // 2 and net r % 2, with the groups'
  members and rows of tests/test_torch_mesh.py's layout; the sizing of
  ``launch`` (the JAX trainer's: the data axis fitted to the batches times
  the extra axes), its shrink message, and the refusals (a net axis of 3
  on a dual run, a job the axis does not divide, a process ``launch`` did
  not start, one card for two ranks);
- one co-teaching step on each rank's net equals net k of the one-process
  step from the same weights, batch and views: metrics (rtol and atol
  1e-5), parameters and BN statistics under tests/test_torch_multidevice.py's
  2*lr rule (AMSGrad's first step moves each parameter by about lr along
  its gradient's sign), once with ``optim.grad_clip_norm`` small enough
  that clipping engages, so the norm is the pair's;
- the nets a ``Trainer`` builds on each rank, from its seed and warm-started
  with noise from a one-net export, equal net k of a one-process trainer's
  pair;
- two epochs of ``Trainer.run`` at each layout against the JAX ``Trainer``
  with ``extra_axes=(("net", 2),)`` on a 4-device mesh (data 2 x net 2)
  from the same weights and view parameters: the history within the JAX
  package's cross-mesh bars (dice 0.03, losses rtol 2e-2 and atol 2e-3,
  discrete keys equal), the same refresh decisions, the working labels
  equal, the ranks of each net ending equal, the files written once, by
  rank 0, and its ``_last_full`` loading into a one-process port trainer
  (the pair equal to the ranks' nets) and into the JAX package's
  ``load_train_state``.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import checkpoint as jckpt
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.core.rank_checks import train_job, unit_checks
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.engine.state import DualTrainState
from aide_tpu_torch.interop.weights import variables_to_state_dict
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


S, V, B, LR, CLIP = 16, 2, 8, 1e-4, 1e-3
NET = (("net", 2),)
LAYOUTS = {2: "net 2", 4: "data 2 x net 2"}


def _cfg(num_devices=0, batch=8, eval_batch=8, extra_axes=NET, **kw):
    cfg = TrainConfig()
    cfg.data.batch_size, cfg.data.eval_batch_size = batch, eval_batch
    cfg.mesh.num_devices = num_devices
    cfg.mesh.extra_axes = extra_axes
    for k, v in kw.items():
        setattr(cfg.mesh, k, v)
    return cfg


# ------------------------------ the layout ------------------------------


@pytest.mark.parametrize("n_avail,batch,eval_batch,want", [
    (2, 8, 8, 2),     # net 2 at data 1
    (4, 8, 8, 4),     # data 2 x net 2
    (8, 8, 8, 8),     # data 4 x net 2
    (8, 4, 6, 4),     # gcd 2: data 2, "MESH SHRUNK" from 8
    (6, 8, 8, 4),     # 3 data shards do not divide 8: data 2
])
def test_fit_ranks_sizes_as_the_jax_trainer(n_avail, batch, eval_batch, want):
    """The JAX trainer's sizing (aide_tpu/engine/trainer.py:141-165): the
    data axis fitted to gcd(batch, eval_batch) over n_avail / extra, times
    extra; ``launch`` starts that many CPU ranks for mesh.num_devices."""
    cfg = _cfg(n_avail, batch, eval_batch)
    assert mesh.fit_ranks(cfg, n_avail) == want
    assert mesh.resolve_ranks(cfg, "cpu") == want


def test_shrunk_message_names_the_extra_axis():
    msg = mesh.shrunk_message(8, _cfg(batch=4, eval_batch=6), 2)
    assert msg.startswith("MESH SHRUNK: 8 devices available") and "shards over 2 (x2 extra-axis devices)" in msg


@pytest.mark.parametrize("num_devices", [0, 1, 3])
def test_a_job_the_net_axis_does_not_divide_raises(num_devices):
    """0 on the CPU is one rank; 1 or 3 ranks do not make pairs."""
    with pytest.raises(ValueError, match=r"needs a multiple of 2 ranks.*CPU ranks"):
        mesh.resolve_ranks(_cfg(num_devices), "cpu")
    with pytest.raises(ValueError, match="not divisible by mesh.extra_axes"):
        mesh.fit_ranks(_cfg(), 3)


def test_a_joined_job_the_net_axis_does_not_divide_raises():
    cfg = _cfg(coordinator_address="127.0.0.1:1", num_processes=3, process_id=0)
    with pytest.raises(ValueError, match="num_processes=3 does not divide into the net axis"):
        mesh.init_distributed(cfg.mesh, "cpu")


@pytest.mark.parametrize("num_devices", [0, 2])
def test_net_axis_on_one_card_raises(monkeypatch, num_devices):
    """On a machine with one card a net axis raises naming the cards: it
    never falls back to CPU ranks or to two ranks on one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="card"):
        mesh.resolve_ranks(_cfg(num_devices), None)
    with pytest.raises(ValueError, match="card"):
        mesh.launch(_never, _cfg(num_devices), None)


def _never(rank, device):
    raise AssertionError("no rank may run")


def test_net_axis_of_three_on_a_dual_run_raises():
    """As place_state: the dual pair needs a net axis of exactly 2."""
    with pytest.raises(ValueError, match="must have size 2"):
        ttrainer.check_mesh(_cfg(6, extra_axes=(("net", 3),)))


@pytest.mark.parametrize("num_devices", [0, 2])
def test_net_axis_outside_launch_raises(num_devices):
    """A process that launch did not start refuses a net axis, naming launch."""
    with pytest.raises(ValueError, match=r"mesh.extra_axes=\(\('net', 2\),\).*mesh.launch"):
        ttrainer.check_mesh(_cfg(num_devices))


# --------------------------- the unit checks ---------------------------


def _step_cfg(clip=None):
    cfg = TrainConfig()
    cfg.model.name, cfg.model.base_width, cfg.model.compute_dtype = "fuseunet", 4, "float32"
    cfg.data.img_size, cfg.data.num_tta_views, cfg.data.warp_method = S, V, "shear"
    cfg.data.batch_size = cfg.data.eval_batch_size = B
    cfg.optim.lr = LR
    cfg.optim.grad_clip_norm = clip
    return cfg


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m in ("1", "2"):
        out[f"modal{m}"] = rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, size=(B, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, size=(B, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in ("target1", "target2"):
        cy, cx, r = rng.uniform(4, 12), rng.uniform(4, 12), rng.uniform(2, 5)
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int64)
        out[t] = np.stack([np.roll(base, int(rng.integers(-2, 3)), axis=1) for _ in range(B)])
    return out


TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=True, num_cases=4, slices_per_case=5,
    size=S, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


def _trainer_cfgs(tmp):
    """The initialising and the warm-starting dual trainer's configs (one
    process; the ranks' copies add the net axis)."""
    cfg = _step_cfg()
    cfg.data.task = "synthetic"
    init = cfg.to_json()
    export = str(tmp / "export.pkl")
    ckpt.export_net(export, ttrainer.init_net(cfg.model, 41).state_dict(), {"epoch": 1})
    cfg.resume_file = export
    cfg.coteach.warm_start_noise = 1e-2
    return [init, cfg.to_json()]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    rng = np.random.default_rng(5)
    cfg = _step_cfg()
    nets = [{k: v.numpy() for k, v in ttrainer.init_net(cfg.model, seed).state_dict().items()}
            for seed in (3, 4)]
    degrees = rng.uniform(-60.0, 60.0, (V, B)).astype(np.float32)
    hflip = (rng.random((V, B)) < 0.5).astype(np.float32)
    step = {"batch": _step_batch(6), "rate": 0.5, "nets": nets, "degrees": degrees,
            "hflip": hflip}
    tmp = tmp_path_factory.mktemp("net_units")
    return {
        "layout": {"batches": [8, 5]},
        "step": dict(step, cfg=_step_cfg().to_json()),
        "step_clip": dict(step, cfg=_step_cfg(CLIP).to_json()),
        "trainer": {"cfgs": _trainer_cfgs(tmp), "task": TASK_ARGS, "workdir": str(tmp)},
    }


def _rank_cfgs(texts, world):
    out = []
    for text in texts:
        cfg = TrainConfig.from_json(text)
        cfg.mesh.num_devices, cfg.mesh.extra_axes = world, NET
        out.append(cfg.to_json())
    return out


@pytest.fixture(scope="module")
def ranks(inputs):
    """{world: {rank: unit_checks' results}} at net 2 (2 ranks) and data 2
    x net 2 (4 ranks); the trainer check at net 2."""
    out = {}
    for world in LAYOUTS:
        sent = {k: v for k, v in inputs.items() if k != "trainer" or world == 2}
        if world == 2:
            sent["trainer"] = dict(inputs["trainer"], cfgs=_rank_cfgs(inputs["trainer"]["cfgs"], 2))
        out[world] = mesh.launch(unit_checks, _cfg(world), "cpu", (sent,))
    return out


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_layout_of_the_ranks(ranks, world):
    """Rank r is data shard r // 2 and net r % 2; its data group holds its
    net's ranks, its pair group its shard's; a shard takes its rows of a
    batch its data axis divides, the whole of one it does not."""
    got = ranks[world]
    assert sorted(got) == list(range(world))
    d_size = world // 2
    for r, res in got.items():
        lay = res["layout"]
        d, k = r // 2, r % 2
        assert (res["world"], lay["data_rank"], lay["net_rank"], lay["data_size"],
                lay["net_size"]) == (world, d, k, d_size, 2)
        assert lay["data_group"] == list(range(k, world, 2))
        assert lay["pair_group"] == [2 * d, 2 * d + 1]
        per = 8 // d_size
        assert lay["rows"][0] == (slice(d * per, (d + 1) * per) if d_size > 1 else slice(None))
        assert lay["rows"][1] == slice(None)


def _one_process_step(inp):
    cfg = TrainConfig.from_json(inp["cfg"])
    nets = []
    for sd in inp["nets"]:
        net = build_model(cfg.model)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        nets.append(net.to(memory_format=torch.channels_last))
    params = [p for n in nets for p in n.parameters()]
    state = DualTrainState(nets[0], nets[1], make_optimizer(params, cfg.optim, 10, 10))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    step = steps.make_coteach_train_step(True, cfg)
    norms = []
    clip = state.optimizer._clip

    def seen(grads):
        norms.append(float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))))
        return clip(grads)

    state.optimizer._clip = seen
    m = step(state, batch, torch.from_numpy(inp["degrees"]), torch.from_numpy(inp["hflip"]),
             inp["rate"])
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [{k: v.detach().numpy() for k, v in n.state_dict().items()} for n in nets],
        "mu": [[state.optimizer.state[p]["mu"].numpy() for p in n.parameters()] for n in nets],
        "names": [[k for k, _ in n.named_parameters()] for n in nets],
        "norms": norms,
    }


@pytest.fixture(scope="module")
def one_process(inputs):
    return {key: _one_process_step(inputs[key]) for key in ("step", "step_clip")}


def test_clipping_engages_in_the_clipped_step(one_process):
    """The pair's gradient norm is over the clipping bound, so the clipped
    step scales every gradient by one factor of both nets."""
    assert one_process["step"]["norms"] == []
    (norm,) = one_process["step_clip"]["norms"]
    assert norm > 10 * CLIP


@pytest.mark.parametrize("key", ["step", "step_clip"])
@pytest.mark.parametrize("world", list(LAYOUTS))
def test_step_metrics_equal_one_process(ranks, one_process, world, key):
    """Every rank returns the pair's metrics, the one process's."""
    want = one_process[key]["metrics"]
    for r, res in ranks[world].items():
        got = res[key]["metrics"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=f"rank {r} {k}")


def _feeds_bn(k):
    """A conv bias that a BatchNorm removes: its gradient is zero up to
    rounding."""
    return (k.endswith(".bias") and k != "last_conv1.bias" and ".bn" not in k
            and not k.endswith("bilinear_up.2.bias"))


def _hold_params(got, ref, grad):
    """tests/test_torch_multidevice.py's bar: within 1e-6 + 1e-2*lr, or 2*lr
    where the gradient is under 5% of its tensor's largest (or feeds a
    norm), the latter for at most 5% of a tensor's elements; BN running
    statistics within rtol 1e-4 and 1e-5 of the tensor's largest."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if "running" in k:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=max(1e-7, 1e-5 * np.abs(r).max()),
                                       err_msg=k)
            continue
        feeds_bn = _feeds_bn(k)
        strict = 1e-6 + 1e-2 * LR
        noise = np.abs(grad[k]) < 5e-2 * np.abs(grad[k]).max()
        if feeds_bn:
            noise[...] = True
        bad = np.abs(g - r) > np.where(noise, 2 * LR, strict)
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(g - r).max()))
        if not feeds_bn:
            flipped = int((np.abs(g - r) > strict).sum())
            assert flipped <= max(1, 0.05 * g.size), (k, flipped, g.size)


@pytest.mark.parametrize("key", ["step", "step_clip"])
@pytest.mark.parametrize("world", list(LAYOUTS))
def test_step_params_equal_one_process(ranks, one_process, world, key):
    """Each rank's net after the step is net k of the one process's pair,
    parameters and BN statistics; the ranks of one net end equal."""
    ref = one_process[key]
    for r, res in ranks[world].items():
        k = r % 2
        (got,) = res[key]["nets"]
        if r >= 2:
            for name, v in ranks[world][k][key]["nets"][0].items():
                np.testing.assert_array_equal(got[name], v, err_msg=f"rank {r} {name}")
            continue
        # optax's first moment after one step is (1 - b1) * the (clipped) gradient
        grad = {n: m / 0.1 for n, m in zip(ref["names"][k], ref["mu"][k])}
        _hold_params(got, ref["nets"][k], grad)


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_step_collectives(ranks, world):
    """Net 2 at data 1: the pair exchange before the losses and the one of
    the loss values after them, and with clipping the norms' exchange; no
    BatchNorm or gradient collective. Data 2 x net 2: besides, the data
    axis's 96 BatchNorm collectives of one net (32 norms in its view
    forward, main forward and backward), the logits' gather and
    reduce-scatter, the targets' fetch and the gradient all-reduce."""
    data = 0 if world == 2 else 32 * 3 + 4
    for res in ranks[world].values():
        assert res["step_collectives"] == 2 + data
        assert res["step_clip_collectives"] == 3 + data


def _one_process_trainer(text, tmp):
    cfg = TrainConfig.from_json(text)
    cfg.checkpoint_dir, cfg.history_dir = str(tmp / "ckpt"), str(tmp / "hist")
    return ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp / "data"), **TASK_ARGS), device="cpu")


@pytest.mark.parametrize("which", ["init", "warm start"])
def test_trainer_nets_on_the_ranks_equal_the_pair(ranks, inputs, tmp_path, which):
    """Rank k's Trainer holds net k of the one-process trainer's pair: from
    seed + k, and warm-started with net k's row of the pair's noise."""
    i = ["init", "warm start"].index(which)
    pair = _one_process_trainer(inputs["trainer"]["cfgs"][i], tmp_path).state.nets
    first = next(iter(pair[0].state_dict()))
    assert not torch.equal(pair[0].state_dict()[first], pair[1].state_dict()[first])
    for r in (0, 1):
        got = ranks[2][r]["trainer"][i]
        assert got["index"] == r and len(got["nets"]) == 1
        for k, v in pair[r].state_dict().items():
            np.testing.assert_array_equal(got["nets"][0][k], v.numpy(), err_msg=f"rank {r} {k}")


# ---------------------------- the trainer job ----------------------------

EPOCHS, STEPS = 2, 2


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX trainer with a net axis on 4 devices (data 2 x net 2) and the
    port's job at each layout through ``mesh.launch``, from the same weights
    and view parameters; the port's jobs run while the JAX one does."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 CPU devices")
    tmp = tmp_path_factory.mktemp("net_job")
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = S
    jcfg.data.batch_size = B
    jcfg.data.eval_batch_size = B  # the test pass: 5 rows, replicated
    jcfg.data.num_tta_views = V
    jcfg.optim.lr = 1e-6
    jcfg.coteach.warmup_epochs = EPOCHS
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 4
    jcfg.mesh.extra_axes = NET
    jcfg.checkpoint_dir = str(tmp / "jax" / "ckpt")
    jcfg.history_dir = str(tmp / "jax" / "hist")
    jtask = JSyntheticTask(root=str(tmp / "jax" / "data"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    assert jtr.mesh.shape == {"data": 2, "net": 2}
    jtr.label_cases = set(jtask.clean_case_ids())

    arrays = {}
    for n in (0, 1):
        sd = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jtr.state.net_variables(n)))
        arrays.update({f"net{n}.{k}": v for k, v in sd.items()})
    views = [[jtta.sample_view_params(
        jprng.step_key(jprng.epoch_key(jtr.root_key, e), i), V, B,
        jcfg.data.rotation_degree, jcfg.data.hflip_prob) for i in range(STEPS)]
        for e in range(EPOCHS)]
    arrays["degrees"] = np.array([[np.array(d) for d, _ in row] for row in views])
    arrays["hflip"] = np.array([[np.array(h) for _, h in row] for row in views])
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    port = {}

    def run_port():
        for world in LAYOUTS:
            cfg.mesh.num_devices = world
            spec = {"cfg": cfg.to_json(), "task": TASK_ARGS, "epochs": EPOCHS}
            np.savez(tmp / f"inputs{world}.npz", spec=json.dumps(spec), **arrays)
            try:
                port[world] = mesh.launch(train_job, cfg, "cpu",
                                          (str(tmp / f"inputs{world}.npz"), str(tmp / f"port{world}")))
            except Exception as err:  # a failed rank: raised below, in the test's thread
                port[world] = err

    thread = threading.Thread(target=run_port)
    thread.start()
    try:
        jtr.run(EPOCHS)
    finally:
        thread.join()
    out = {"jax": jtr, "tmp": tmp, "cfg": cfg}
    for world in LAYOUTS:
        if isinstance(port[world], Exception):
            raise port[world]
        results = []
        for r in range(world):
            res = dict(port[world][r])
            with np.load(tmp / f"port{world}" / f"rank{r}" / "state.npz") as z:
                res["state"] = {k: z[k] for k in z.files}
            results.append(res)
        out[world] = results
    return out


def _metrics(history):
    return [{k: v for k, v in row.items() if not k.startswith("time")} for row in history]


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_ran_at_the_layout(job, world):
    assert [(r["rank"], r["world"], r["net_size"], r["held"]) for r in job[world]] == [
        (r, world, 2, [r % 2]) for r in range(world)]


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_history_matches_jax(job, world):
    """The JAX package's cross-mesh bars (tests/test_multidevice_epoch.py):
    dice within 0.03, losses rtol 2e-2 and atol 2e-3, the rest equal."""
    jh, th = _metrics(job["jax"].history), job[world][0]["history"]
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        for key, v in j.items():
            if "dice" in key:
                assert abs(t[key] - v) < 0.03, (key, t[key], v)
            elif "loss" in key:
                np.testing.assert_allclose(t[key], v, rtol=2e-2, atol=2e-3, err_msg=key)
            else:
                assert t[key] == v, key


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_refresh_decisions_match_jax(job, world):
    want = [[e, n, list(sel), list(done)] for e, n, sel, done in job["jax"].refresh_log]
    assert len(want) == 2 * EPOCHS
    for res in job[world]:
        assert res["refresh_log"] == want


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_ranks_agree(job, world):
    """Every rank ends with the same history and working labels (host, and
    on the device), the ranks of each net with the same parameters and BN
    statistics."""
    first = job[world][0]
    for res in job[world]:
        assert res["history"] == first["history"]
        for n in (1, 2):
            np.testing.assert_array_equal(res["state"][f"labels{n}"], first["state"][f"labels{n}"])
            labels = res["state"][f"labels{n}"]
            device = res["state"][f"device_labels{n}"]
            d = res["rank"] // 2
            rows = np.clip(np.arange(d * len(device), (d + 1) * len(device)), 0, len(labels) - 1)
            np.testing.assert_array_equal(device, labels[rows] if world > 2 else labels)
        partner = job[world][res["rank"] % 2]
        for k, v in partner["state"].items():
            if k.startswith("net"):
                np.testing.assert_array_equal(res["state"][k], v, err_msg=k)


@pytest.mark.parametrize("net", [1, 2])
@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_working_labels_equal_jax(job, world, net):
    np.testing.assert_array_equal(job[world][0]["state"][f"labels{net}"],
                                  job["jax"].train_pipe.labels.get(net))


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_files_written_once(job, world):
    """Rank 0 wrote the log, the history, both nets' exports, the _full
    files and the tempmasks; no other rank wrote anything."""
    files = job[world][0]["files"]
    assert any(f.startswith("hist/") and f.endswith("_history.json") for f in files)
    assert any(f.startswith("hist/") and f.endswith(".log") for f in files)
    assert any(f.endswith("_last_full.msgpack") for f in files)
    for n in (1, 2):
        assert any(f.endswith(f"_net{n}_besttraincasedice.pkl") for f in files)
    assert any(f.startswith("data/tempmasks") for f in files)
    for res in job[world][1:]:
        assert res["files"] == []


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_job_last_full_loads_in_one_process_and_in_jax(job, world):
    """Rank 0's _last_full holds the pair: a one-process port trainer
    resumed from it holds the ranks' nets bit for bit, and the JAX
    package's load_train_state reads the same tree."""
    cfg = job["cfg"]
    work = job["tmp"] / f"port{world}" / "rank0"
    path = ckpt.full_path(str(work / "ckpt"), cfg.experiment_name, last=True)
    one = TrainConfig.from_json(cfg.to_json())
    one.mesh.num_devices, one.mesh.extra_axes = 1, ()
    one.resume_file = path
    one.checkpoint_dir = one.history_dir = str(job["tmp"] / f"resume{world}")
    tr = ttrainer.Trainer(one, SyntheticTask(root=str(work / "data"), **TASK_ARGS), device="cpu")
    assert tr.start_epoch == EPOCHS and tr.state.optimizer.count == EPOCHS * STEPS
    for k, net in enumerate(tr.state.nets):
        held = job[world][k]["state"]
        for name, v in net.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), held[f"net{k}.{name}"], err_msg=name)
    jstate = jckpt.load_train_state(path, job["jax"].state)
    jtree = serialization.to_state_dict(jax.device_get(jckpt.state_tree(jstate)))
    ptree = ckpt.state_tree(tr.state)

    def equal(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for key in a:
                equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    equal(jtree, ptree)
    assert int(jnp.asarray(jstate.step)) == EPOCHS * STEPS


@pytest.mark.parametrize("variant", ["proposed", "comparison"])
def test_cli_trains_a_net_axis_on_cpu_ranks(tmp_path, variant):
    """``train --device cpu --set mesh.num_devices=2
    'mesh.extra_axes=[["net",2]]'`` starts two gloo ranks: one log, one
    history and the exports, whose rows are a one-rank trainer's on the
    same config (the smoke preset's GroupNorm UNet at 32 px: the same
    seeds) within tests/test_torch_epoch.py's bars. The co-teaching run
    puts one net on each rank; the supervised (comparison) run replicates
    its net over the axis and says so, as the JAX trainer does."""
    from aide_tpu_torch.cli.main import main as cli
    from aide_tpu_torch.cli.presets import get_preset

    def settings(sub):
        return [f"data.root={tmp_path / sub / 'data'}", f"checkpoint_dir={tmp_path / sub / 'ckpt'}",
                f"history_dir={tmp_path / sub / 'hist'}", "data.img_size=32",
                "model.base_width=2", 'data.task_options={"num_cases": 4, "slices_per_case": 4}',
                f"data.variant={variant}", f"coteach.enabled={variant == 'proposed'}"]

    assert cli(["train", "--preset", "synthetic_smoke", "--device", "cpu", "--epochs", "2",
                "--set", *settings("net"), "mesh.num_devices=2",
                'mesh.extra_axes=[["net",2]]']) == 0
    cfg = get_preset("synthetic_smoke").override(settings("one") + ["mesh.num_devices=1"])
    want = ttrainer.Trainer(cfg, device="cpu").run(2)
    with open(tmp_path / "net" / "hist" / f"{cfg.experiment_name}_history.json") as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key, v in w.items():
            if not key.startswith("time"):
                np.testing.assert_allclose(g[key], v, rtol=1e-3, atol=1e-3 if "dice" in key else 0,
                                           err_msg=key)
    with open(tmp_path / "net" / "hist" / f"{cfg.experiment_name}.log") as fh:
        log = fh.read()
    assert log.count("Start Training") == 1 and log.count("epoch[2/") == (
        2 if variant == "proposed" else 1)
    assert ("the state replicates over it" in log) == (variant == "comparison")
    assert sorted(os.listdir(tmp_path / "net" / "ckpt")) == sorted(
        os.listdir(tmp_path / "one" / "ckpt"))
