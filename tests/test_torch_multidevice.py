"""The port's data axis on two CPU ranks over gloo, against one process and
against the JAX package on a 2-device CPU mesh.

The ranks run the programs of ``aide_tpu_torch.core.rank_checks``: spawned
once for the module through ``mesh.launch`` (so they import neither JAX nor
this file), and, for the trainer, as two ``python -m`` processes joined by
``mesh.coordinator_address`` (the counterpart of tests/test_multihost.py).
Each rank uses one torch thread. The inputs are NumPy arrays from a seed.

- (a) a train-mode BatchNorm on each rank's rows equals one process on the
  whole batch: output, input and parameter gradients, running statistics
  (rtol 1e-5, atol 1e-6), with one all-reduce a forward;
- (b) one co-teaching step (FuseUNet, base width 4, 32 px, batch 4, 2
  views, f32) on 2 ranks: the ranks end equal, and equal one rank (metrics
  rtol 1e-5, gradients within 1e-4 of each tensor's largest) and the JAX
  step on a 2-device mesh (metrics rtol 1e-4), the new parameters held as
  tests/test_torch_step.py holds them (AMSGrad moves each parameter by
  about lr along its gradient's sign, so where that sign is rounding noise
  two correct runs land 2*lr apart);
- (c) the sharded cache's gathers (a batch that divides the ranks and a
  ragged one) and label scatter, and ``fetch``, equal NumPy;
- the nets a trainer initialises from its seed are equal on both ranks
  and to this process's;
- (d) two epochs of ``Trainer.run`` at world 2 (refresh, case evaluation,
  the checkpoint gate, a ragged replicated test batch) against the JAX
  ``Trainer`` on a 2-device mesh from the same weights and view
  parameters: history within tests/test_torch_epoch.py's bars (rtol 1e-3,
  dice 1e-3 absolute), the same refresh decisions, identical histories,
  labels and parameters on both ranks, the working labels equal to the JAX
  run's, and the files written once, by rank 0.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import MeshConfig as JMeshConfig
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.core.mesh import make_mesh, shard_batch
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine import steps as jsteps
from aide_tpu.engine.state import DualTrainState as JDualState
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.models.fuseunet import FuseUNet as JFuseUNet
from aide_tpu.ops import make_optimizer as j_make_optimizer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.core.rank_checks import unit_checks
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine.state import DualTrainState
from aide_tpu_torch.engine.trainer import init_net
from aide_tpu_torch.interop.weights import variables_to_state_dict
from aide_tpu_torch.models import build_model
from aide_tpu_torch.models.blocks import BatchNorm
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, V, B, LR = 32, 2, 4, 1e-4


def _np_tree(t):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), t)


def _step_cfgs():
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.img_size = S
    jcfg.data.batch_size = B
    jcfg.data.eval_batch_size = B
    jcfg.data.num_tta_views = V
    jcfg.data.warp_method = "shear"
    return jcfg, TrainConfig.from_dict(jcfg.to_dict())


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for m in ("1", "2"):
        out[f"modal{m}"] = rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, size=(B, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, size=(B, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:S, 0:S]
    for t in ("target1", "target2"):
        cy, cx, r = rng.uniform(8, 24), rng.uniform(8, 24), rng.uniform(4, 10)
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int32)
        out[t] = np.stack([np.roll(base, int(rng.integers(-3, 4)), axis=1) for _ in range(B)])
    return out


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    bn = {
        "x": rng.normal(0.5, 1.5, (8, 5, 6, 6)).astype(np.float32),
        "g": rng.normal(0.0, 1.0, (8, 5, 6, 6)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.5, 5).astype(np.float32),
        "bias": rng.normal(0.0, 0.5, 5).astype(np.float32),
        "running_mean": rng.normal(0.0, 0.1, 5).astype(np.float32),
        "running_var": rng.uniform(0.5, 1.5, 5).astype(np.float32),
    }
    jcfg, cfg = _step_cfgs()
    jmodel = JFuseUNet(num_classes=2, base_width=4, compute_dtype="float32")
    x = jnp.zeros((1, S, S, 3))
    variables = [jmodel.init(jax.random.key(k), x, x, train=False) for k in (0, 1)]
    key = jax.random.key(100)
    degrees, hflip = jtta.sample_view_params(key, V, B, jcfg.data.rotation_degree,
                                             jcfg.data.hflip_prob)
    step = {
        "cfg": cfg.to_json(), "batch": _step_batch(10), "rate": 0.5,
        "nets": [variables_to_state_dict(_np_tree(v)) for v in variables],
        "degrees": np.array(degrees), "hflip": np.array(hflip),
    }
    n, hw = 21, 8
    cache = {
        "arrays": {
            "image": rng.integers(0, 255, (n, hw, hw, 3)).astype(np.uint8),
            "scale": rng.random((n, 3)).astype(np.float32),
            "target": rng.integers(0, 2, (n, hw, hw)).astype(np.uint8),
            "target1": rng.integers(0, 2, (n, hw, hw)).astype(np.uint8),
        },
        "gathers": [rng.integers(0, n, 8), rng.integers(0, n, 5)],
        "scatter": (np.array([0, 3, 7, 11, 20]), rng.integers(0, 2, (5, hw, hw)).astype(np.uint8)),
        "fetch": [rng.normal(size=(4, 3)).astype(np.float32), rng.random((4, 5)) > 0.5,
                  rng.integers(-9, 9, (4, 2, 2))],
    }
    return {"bn": bn, "step": step, "cache": cache, "init": {"cfg": cfg.to_json()},
            "jax": (jcfg, jmodel, variables, key)}


@pytest.fixture(scope="module")
def ranks(inputs):
    cfg = TrainConfig()
    cfg.data.batch_size = cfg.data.eval_batch_size = B
    cfg.mesh.num_devices = 2
    sent = {k: v for k, v in inputs.items() if k != "jax"}
    return mesh.launch(unit_checks, cfg, "cpu", (sent,))


def test_a_failing_rank_fails_the_launch():
    """A rank whose function raises ends the launch: the error comes back
    here with its traceback, and no rank is left running."""
    cfg = TrainConfig()
    cfg.data.batch_size = cfg.data.eval_batch_size = B
    cfg.mesh.num_devices = 2
    with pytest.raises(Exception, match="TypeError"):
        mesh.launch(unit_checks, cfg, "cpu", ({"bn": None},))


def test_two_ranks_ran(ranks):
    assert sorted(ranks) == [0, 1]
    assert [(ranks[r]["world"], ranks[r]["rank"]) for r in (0, 1)] == [(2, 0), (2, 1)]


# ------------------------------ (a) BatchNorm ------------------------------


@pytest.fixture(scope="module")
def bn_reference(inputs):
    inp = inputs["bn"]
    bn = BatchNorm(inp["x"].shape[1])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(inp[k]))
    bn.train()
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(inp["g"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


@pytest.mark.parametrize("key", ["y", "dx", "dweight", "dbias", "running_mean", "running_var"])
def test_global_batchnorm_equals_one_process(ranks, bn_reference, key):
    if key in ("y", "dx"):
        got = np.concatenate([ranks[r]["bn"][key] for r in (0, 1)])
    else:
        got = ranks[0]["bn"][key]
        np.testing.assert_array_equal(ranks[1]["bn"][key], got)
    np.testing.assert_allclose(got, bn_reference[key], rtol=1e-5, atol=1e-6)


def test_global_batchnorm_collectives(ranks):
    """One all-gather a train-mode forward (each rank's per-channel mean and
    inverse std), one all-reduce in its backward, one for the gradients;
    the statistics-free TTA forward gathers too and folds nothing; outside
    ``global_batch_stats`` a norm runs no collective."""
    for r in (0, 1):
        assert ranks[r]["bn_collectives"] == 4
        assert ranks[r]["bn"]["untouched_by_tta"]


def test_batchnorm_outside_the_step_takes_its_own_rows(ranks, inputs):
    """A train-mode forward outside ``global_batch_stats`` (a probe that
    only some ranks might run) normalises with this rank's rows alone."""
    inp = inputs["bn"]
    half = inp["x"].shape[0] // 2
    for r in (0, 1):
        bn = BatchNorm(inp["x"].shape[1])
        with torch.no_grad():
            for k in ("weight", "bias"):
                getattr(bn, k).copy_(torch.from_numpy(inp[k]))
        bn.train()
        with torch.no_grad():
            want = bn(torch.from_numpy(inp["x"][r * half:(r + 1) * half]), update_stats=False)
        np.testing.assert_allclose(ranks[r]["bn"]["y_local"], want.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------- (b) co-teaching step ----------------------------


def _port_step(inputs):
    inp = inputs["step"]
    cfg = TrainConfig.from_json(inp["cfg"])
    nets = []
    for sd in inp["nets"]:
        net = build_model(cfg.model)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        nets.append(net.to(memory_format=torch.channels_last))
    params = [p for n in nets for p in n.parameters()]
    state = DualTrainState(nets[0], nets[1], make_optimizer(params, cfg.optim, 10, 10))
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    batch["target1"], batch["target2"] = batch["target1"].long(), batch["target2"].long()
    m = steps.make_coteach_train_step(True, cfg)(
        state, batch, torch.from_numpy(inp["degrees"]), torch.from_numpy(inp["hflip"]), 0.5)
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [{k: v.detach().numpy() for k, v in n.state_dict().items()} for n in nets],
        "mu": [[state.optimizer.state[p]["mu"].numpy() for p in n.parameters()] for n in nets],
        "names": [[k for k, _ in n.named_parameters()] for n in nets],
    }


@pytest.fixture(scope="module")
def one_rank(inputs):
    return _port_step(inputs)


@pytest.fixture(scope="module")
def jax_two_devices(inputs):
    jcfg, jmodel, variables, key = inputs["jax"]
    tx = j_make_optimizer(jcfg.optim, steps_per_epoch=10, num_epochs=10)
    jstate = JDualState.create(*variables, tx)
    jstep = jsteps.make_coteach_train_step(jmodel, True, jcfg)
    jm = make_mesh(JMeshConfig(num_devices=2))
    batch = shard_batch({k: jnp.asarray(v) for k, v in inputs["step"]["batch"].items()}, jm)
    jstate, m = jstep(jstate, batch, key, jnp.asarray(0.5, jnp.float32))
    return {
        "metrics": {k: float(v) for k, v in m.items()},
        "nets": [variables_to_state_dict(_np_tree(jstate.net_variables(n))) for n in (0, 1)],
        "mu": _np_tree(jstate.opt_state[0].mu),
        "stats": [_np_tree(jstate.net_variables(n))["batch_stats"] for n in (0, 1)],
    }


def test_step_ranks_end_equal(ranks):
    a, b = ranks[0]["step"], ranks[1]["step"]
    assert a["metrics"] == b["metrics"]
    for n in (0, 1):
        for k, v in a["nets"][n].items():
            np.testing.assert_array_equal(b["nets"][n][k], v, err_msg=k)


def test_step_collectives(ranks):
    """Two gathers (the logits with gradient; pseudo-labels, weight maps
    and targets in one), a reduce-scatter back, one gradient all-reduce,
    and the BatchNorms' all-reduces: each of the 32 of a net once in each
    of its forwards (views, main) and once in the main backward."""
    assert ranks[0]["step_collectives"] == ranks[1]["step_collectives"] == 2 + 1 + 1 + 2 * 32 * 3


@pytest.mark.parametrize("key", ["loss1", "loss2", "dice1_sum", "dice2_sum", "count"])
def test_step_metrics_equal_one_rank(ranks, one_rank, key):
    np.testing.assert_allclose(ranks[0]["step"]["metrics"][key], one_rank["metrics"][key],
                               rtol=1e-5)


def _feeds_bn(k):
    """A conv bias that a BatchNorm removes: its gradient is zero up to
    rounding."""
    return (k.endswith(".bias") and k != "last_conv1.bias" and ".bn" not in k
            and not k.endswith("bilinear_up.2.bias"))


@pytest.mark.parametrize("net", [0, 1])
def test_step_gradients_equal_one_rank(ranks, one_rank, net):
    """The gradients summed over the ranks are one process's: within 1e-4
    of each tensor's largest, and the rounding-noise gradients of the
    biases a BatchNorm removes under 1e-6 of the net's largest."""
    largest = max(np.abs(m).max() for m in one_rank["mu"][net])
    for name, got, want in zip(one_rank["names"][net], ranks[0]["step"]["mu"][net],
                               one_rank["mu"][net]):
        if _feeds_bn(name):
            assert max(np.abs(got).max(), np.abs(want).max()) < 1e-6 * largest, name
            continue
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def _hold_params(got, ref, grad):
    """tests/test_torch_step.py's bar: within 1e-6 + 1e-2*lr, or 2*lr where
    the gradient is under 5% of its tensor's largest (or feeds a norm),
    the latter for at most 5% of a tensor's elements; BN running statistics
    within rtol 1e-4 and 1e-5 of the tensor's largest."""
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if "running" in k:
            # a mean over the rows, summed in another order: rounding of the
            # order of its tensor's largest element
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


@pytest.mark.parametrize("net", [0, 1])
def test_step_params_equal_one_rank(ranks, one_rank, net):
    grad = {k: m / 0.1 for k, m in zip(one_rank["names"][net], one_rank["mu"][net])}
    _hold_params(ranks[0]["step"]["nets"][net], one_rank["nets"][net], grad)


@pytest.mark.parametrize("key", ["loss1", "loss2", "dice1_sum", "dice2_sum", "count"])
def test_step_metrics_equal_jax_on_two_devices(ranks, jax_two_devices, key):
    np.testing.assert_allclose(ranks[0]["step"]["metrics"][key], jax_two_devices["metrics"][key],
                               rtol=1e-4)


@pytest.mark.parametrize("net", [0, 1])
def test_step_params_equal_jax_on_two_devices(ranks, jax_two_devices, net):
    # optax's first moment after one step is (1 - b1) * grad
    grad = variables_to_state_dict({
        "params": jax.tree_util.tree_map(lambda x: x[net] / 0.1, jax_two_devices["mu"]),
        "batch_stats": jax_two_devices["stats"][net],
    })
    _hold_params(ranks[0]["step"]["nets"][net], jax_two_devices["nets"][net], grad)


# ------------------------------ (c) the cache ------------------------------


@pytest.mark.parametrize("which", [0, 1])
def test_sharded_cache_gather(ranks, inputs, which):
    """The divisible batch (8 of 21 rows) comes back as each rank's half,
    the ragged one (5) whole on both; targets widened to int64."""
    arrays = inputs["cache"]["arrays"]
    idx = inputs["cache"]["gathers"][which]
    for r in (0, 1):
        got = ranks[r]["cache"]["gathers"][which]
        rows = slice(r * len(idx) // 2, (r + 1) * len(idx) // 2) if len(idx) % 2 == 0 else slice(None)
        assert sorted(got) == sorted(arrays)
        for k, v in arrays.items():
            want = v[idx][rows]
            np.testing.assert_array_equal(got[k], want, err_msg=f"{k} rank {r}")
            assert got[k].dtype == (np.int64 if k.startswith("target") else v.dtype)
    assert ranks[0]["cache"]["images_only"] == ["image", "scale"]


def test_sharded_cache_scatter(ranks, inputs):
    arrays = inputs["cache"]["arrays"]
    idx, rows = inputs["cache"]["scatter"]
    n = len(arrays["target1"])
    want = arrays["target1"][np.clip(np.arange(22), 0, n - 1)]  # padded to 2 x 11
    want[idx] = rows
    got = np.concatenate([ranks[r]["cache"]["block"] for r in (0, 1)])
    np.testing.assert_array_equal(got, want)
    expect = want[:n][inputs["cache"]["gathers"][0]]
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["cache"]["after"], expect[r * 4:(r + 1) * 4])


def test_fetch_mixed_dtypes(ranks, inputs):
    for r in (0, 1):
        for got, want in zip(ranks[r]["cache"]["fetch"], inputs["cache"]["fetch"]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_initial_weights_equal_on_ranks(ranks, inputs):
    cfg = TrainConfig.from_json(inputs["init"]["cfg"])
    mine = [init_net(cfg.model, seed).state_dict() for seed in (cfg.seed, cfg.seed + 1)]
    for r in (0, 1):
        for n in (0, 1):
            for k, v in mine[n].items():
                np.testing.assert_array_equal(ranks[r]["init"][n][k], v.numpy(), err_msg=k)


# --------------------------- (d) the trainer job ---------------------------

EPOCHS, STEPS = 2, 5
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=True, num_cases=4, slices_per_case=5,
    size=32, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=8,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX trainer on a 2-device mesh and two port processes at world
    2, from the same weights and view parameters; the port job runs while
    the JAX one does."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 CPU devices")
    tmp = tmp_path_factory.mktemp("job")
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 4  # the test pass: 4 rows sharded, then 1 replicated
    jcfg.data.num_tta_views = 2
    jcfg.optim.lr = 1e-6
    jcfg.coteach.warmup_epochs = EPOCHS
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 2
    jcfg.checkpoint_dir = str(tmp / "jax" / "ckpt")
    jcfg.history_dir = str(tmp / "jax" / "hist")
    jtask = JSyntheticTask(root=str(tmp / "jax" / "data"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    assert jtr.mesh.devices.size == 2
    jtr.label_cases = set(jtask.clean_case_ids())

    arrays = {}
    for n in (0, 1):
        sd = variables_to_state_dict(_np_tree(jtr.state.net_variables(n)))
        arrays.update({f"net{n}.{k}": v for k, v in sd.items()})
    views = [[jtta.sample_view_params(
        jprng.step_key(jprng.epoch_key(jtr.root_key, e), i), 2, 4,
        jcfg.data.rotation_degree, jcfg.data.hflip_prob) for i in range(STEPS)]
        for e in range(EPOCHS)]
    arrays["degrees"] = np.array([[np.array(d) for d, _ in row] for row in views])
    arrays["hflip"] = np.array([[np.array(h) for _, h in row] for row in views])
    spec = {"cfg": TrainConfig.from_dict(jcfg.to_dict()).to_json(), "task": TASK_ARGS,
            "epochs": EPOCHS}
    np.savez(tmp / "inputs.npz", spec=json.dumps(spec), **arrays)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "aide_tpu_torch.core.rank_checks",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
         "--inputs", str(tmp / "inputs.npz"), "--workdir", str(tmp / f"rank{r}")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in (0, 1)]
    try:
        jtr.run(EPOCHS)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in (0, 1):
        with open(tmp / f"rank{r}" / "result.json") as fh:
            res = json.load(fh)
        with np.load(tmp / f"rank{r}" / "state.npz") as z:
            res["state"] = {k: z[k] for k in z.files}
        results.append(res)
    return {"jax": jtr, "ranks": results}


def test_job_ran_at_world_two(job):
    assert [(r["rank"], r["world"]) for r in job["ranks"]] == [(0, 2), (1, 2)]


def test_job_history_matches_jax(job):
    jh, th = job["jax"].history, job["ranks"][0]["history"]
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == {k for k in j if not k.startswith("time")}
        for key in t:
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")


def test_job_refresh_decisions_match_jax(job):
    want = [[e, n, list(sel), list(done)] for e, n, sel, done in job["jax"].refresh_log]
    assert len(want) == 2 * EPOCHS
    assert job["ranks"][0]["refresh_log"] == job["ranks"][1]["refresh_log"] == want


def test_job_ranks_identical(job):
    """Identical histories, working labels (host and the device blocks) and
    final parameters and BN statistics on both ranks."""
    a, b = job["ranks"]
    assert a["history"] == b["history"]
    assert set(a["state"]) == set(b["state"])
    for k, v in a["state"].items():
        if not k.startswith("device_labels"):
            np.testing.assert_array_equal(b["state"][k], v, err_msg=k)
    for n in (1, 2):
        labels = a["state"][f"labels{n}"]
        blocks = np.concatenate([r["state"][f"device_labels{n}"] for r in (a, b)])
        np.testing.assert_array_equal(blocks[: len(labels)], labels)


@pytest.mark.parametrize("net", [1, 2])
def test_job_working_labels_equal_jax(job, net):
    np.testing.assert_array_equal(job["ranks"][0]["state"][f"labels{net}"],
                                  job["jax"].train_pipe.labels.get(net))


def test_job_files_written_once(job):
    """Rank 0 wrote the log, the history, the checkpoints and the
    tempmasks; rank 1 nothing."""
    files = job["ranks"][0]["files"]
    assert any(f.startswith("hist/") and f.endswith("_history.json") for f in files)
    assert any(f.startswith("hist/") and f.endswith(".log") for f in files)
    assert any(f.endswith("_last_full.msgpack") for f in files)
    assert any(f.endswith("_besttraincasedice.pkl") for f in files)
    assert any(f.startswith("data/tempmasks") for f in files)
    assert job["ranks"][1]["files"] == []


def test_cli_trains_two_cpu_ranks(tmp_path):
    """``train --device cpu --set mesh.num_devices=2`` starts two gloo
    ranks: one log, one history and one set of exports, whose rows are a
    one-rank trainer's on the same config (the smoke preset's GroupNorm
    UNet at 32 px: the same seeds, the gradients summed in another order)
    within tests/test_torch_epoch.py's bars."""
    from aide_tpu_torch.cli.main import main as cli
    from aide_tpu_torch.cli.presets import get_preset
    from aide_tpu_torch.engine.trainer import Trainer

    def settings(sub, n):
        return [f"data.root={tmp_path / sub / 'data'}", f"checkpoint_dir={tmp_path / sub / 'ckpt'}",
                f"history_dir={tmp_path / sub / 'hist'}", "data.img_size=32",
                "model.base_width=2", 'data.task_options={"num_cases": 4, "slices_per_case": 4}',
                f"mesh.num_devices={n}"]

    assert cli(["train", "--preset", "synthetic_smoke", "--device", "cpu", "--epochs", "2",
                "--set", *settings("two", 2)]) == 0
    cfg = get_preset("synthetic_smoke").override(settings("one", 1))
    want = Trainer(cfg, device="cpu").run(2)
    with open(tmp_path / "two" / "hist" / f"{cfg.experiment_name}_history.json") as fh:
        got = json.load(fh)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key, v in w.items():
            if not key.startswith("time"):
                np.testing.assert_allclose(g[key], v, rtol=1e-3, atol=1e-3 if "dice" in key else 0,
                                           err_msg=key)
    with open(tmp_path / "two" / "hist" / f"{cfg.experiment_name}.log") as fh:
        log = fh.read()
    assert log.count("Start Training") == 1 and log.count("epoch[2/") == 2
    assert sorted(os.listdir(tmp_path / "two" / "ckpt")) == sorted(
        os.listdir(tmp_path / "one" / "ckpt"))
