"""The port's data-axis helpers (``aide_tpu_torch.core.mesh``) on one process.

``fit_data_devices`` and ``pad_to_multiple`` equal the JAX package's; the
rows ``shard_rows`` gives rank r of N (N = 2 and 4, divisible and ragged
batches) are the rows ``aide_tpu.core.mesh.shard_batch`` places on device r
of an N-device CPU mesh; the launcher's resolution of ``mesh.num_devices``
0 / 1 / N and its shrink to the batches' gcd; the collectives' backend
following the device; the refusals of the net and space axes and of a data
axis asked of a process that ``launch`` did not start; every helper the
identity at world size 1, so a single process runs the single-card code;
and there a train-mode BatchNorm equal to ``F.batch_norm``, folding flax's
running statistics with no collective. The ranks themselves run in
tests/test_torch_multidevice.py.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aide_tpu.core import mesh as jmesh
from aide_tpu.core.config import MeshConfig as JMeshConfig

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.models.blocks import BatchNorm, global_batch_stats


def _cfg(num_devices=0, batch=8, eval_batch=32, **mesh_kw):
    cfg = TrainConfig()
    cfg.data.batch_size = batch
    cfg.data.eval_batch_size = eval_batch
    cfg.mesh.num_devices = num_devices
    for k, v in mesh_kw.items():
        setattr(cfg.mesh, k, v)
    return cfg


@pytest.mark.parametrize("batch", [1, 4, 6, 7, 8, 12, 32])
@pytest.mark.parametrize("avail", [1, 2, 3, 4, 8])
def test_fit_data_devices_matches_jax(batch, avail):
    assert mesh.fit_data_devices(batch, avail) == jmesh.fit_data_devices(batch, avail)


@pytest.mark.parametrize("n,m", [(21, 8), (24, 8), (0, 4), (5, 1), (7, 2)])
def test_pad_to_multiple_matches_jax(n, m):
    assert mesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def _as_rank(monkeypatch, n, r):
    monkeypatch.setattr(mesh, "world_size", lambda: n)
    monkeypatch.setattr(mesh, "rank", lambda: r)


@pytest.mark.parametrize("b", [8, 5, 12])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_rows_are_shard_batch_rows(monkeypatch, n, b):
    """Rank r's rows of a global batch are device r's block of the JAX
    package's batch sharding; a batch N does not divide stays whole on
    every rank, as shard_batch replicates it."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} CPU devices (the conftest's mesh)")
    rng = np.random.default_rng(b * 10 + n)
    batch = {"image": rng.integers(0, 255, (b, 4, 4, 3)).astype(np.uint8),
             "scale": rng.random((b, 3)).astype(np.float32)}
    jm = jmesh.make_mesh(JMeshConfig(num_devices=n))
    placed = jmesh.shard_batch(batch, jm)
    for key, arr in placed.items():
        by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r, dev in enumerate(jm.devices.reshape(-1)):
            _as_rank(monkeypatch, n, r)
            got = mesh.shard_rows(batch)[key]
            np.testing.assert_array_equal(got, by_device[dev], err_msg=f"{key} rank {r}")
            assert mesh.rows_sharded(b) == (b % n == 0)


def test_shard_rows_of_tensors(monkeypatch):
    _as_rank(monkeypatch, 2, 1)
    t = torch.arange(8).reshape(4, 2)
    assert torch.equal(mesh.shard_rows({"t": t})["t"], t[2:])
    assert mesh.local_rows(3) == slice(None)


@pytest.mark.parametrize("num_devices,batch,eval_batch,want", [
    (0, 8, 32, 1),   # 0 on the CPU: one rank
    (1, 8, 32, 1),
    (2, 8, 32, 2),
    (4, 8, 32, 4),
    (4, 4, 6, 2),    # shrunk to gcd(4, 6) = 2
    (3, 4, 4, 2),    # the largest count <= 3 dividing 4
])
def test_launcher_resolves_num_devices(num_devices, batch, eval_batch, want):
    assert mesh.resolve_ranks(_cfg(num_devices, batch, eval_batch), "cpu") == want


def test_launcher_without_a_card_raises():
    """The ranks default to the card; without one nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.launch(_one_rank, _cfg(2), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.resolve_ranks(_cfg(0), "cuda")


def _one_rank(rank, device, tag):
    return (tag, rank, str(device), mesh.world_size(), mesh.in_group())


def test_launch_of_one_rank_runs_in_process():
    """One rank (asked, or a shrink to 1) runs in this process with no
    process group."""
    assert mesh.launch(_one_rank, _cfg(1), "cpu", ("a",)) == {0: ("a", 0, "cpu", 1, False)}
    assert mesh.launch(_one_rank, _cfg(2, batch=3, eval_batch=3), "cpu", ("b",)) == {
        0: ("b", 0, "cpu", 1, False)}


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"), ("cuda:1", "nccl")])
def test_backend_follows_the_device(device, backend):
    assert mesh.backend_for(device) == backend


def test_backend_refuses_other_devices():
    with pytest.raises(ValueError, match="no collectives backend"):
        mesh.backend_for("meta")


@pytest.mark.parametrize("axes,name", [
    ((("net", 2),), "net"), ((("space", 2),), "space"), ((("net", 2), ("space", 2)), "net"),
    ((("model", 2),), "model"),
])
def test_net_and_space_axes_are_refused(axes, name):
    """The net and space axes are accepted, alone or together: launch sizes
    their ranks (2 for 2 devices; net 2 x space 2 needs a multiple of 4),
    and a trainer in a process that launch did not start refuses them,
    naming launch. An axis neither package has is refused."""
    cfg = _cfg(2, extra_axes=axes)
    if name == "model":
        with pytest.raises(NotImplementedError, match="unknown mesh axis 'model'"):
            mesh.refuse_axes(cfg.mesh)
        with pytest.raises(NotImplementedError, match="unknown mesh axis"):
            mesh.launch(_one_rank, cfg, "cpu", ("x",))
        return
    mesh.refuse_axes(cfg.mesh)
    if len(axes) == 1:
        assert mesh.resolve_ranks(cfg, "cpu") == 2
    else:
        with pytest.raises(ValueError, match="needs a multiple of 4 ranks"):
            mesh.resolve_ranks(cfg, "cpu")
    with pytest.raises(ValueError, match="mesh.launch"):
        ttrainer.check_mesh(cfg)


def test_axes_of_size_one_are_accepted():
    mesh.refuse_axes(_cfg(extra_axes=(("net", 1),)).mesh)


@pytest.mark.parametrize("kw", [
    dict(num_devices=2), dict(num_devices=4),
    dict(coordinator_address="127.0.0.1:1", num_processes=2, process_id=0),
])
def test_trainer_outside_launch_refuses_a_data_axis(kw):
    """A config that asks for more than one rank raises, naming launch,
    in a process that launch did not start."""
    with pytest.raises(ValueError, match="mesh.launch"):
        ttrainer.check_mesh(_cfg(batch=8, eval_batch=8, **kw))


def test_trainer_outside_launch_takes_a_config_that_shrinks_to_one():
    assert ttrainer.check_mesh(_cfg(num_devices=2, batch=3, eval_batch=3)) == 1


def test_join_needs_the_job_shape():
    cfg = _cfg(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2)
    with pytest.raises(ValueError, match="process_id"):
        mesh.init_distributed(cfg.mesh, "cpu")


def test_world_of_one_is_the_identity():
    """Without a process group every helper leaves its input as it is: the
    single-card path computes nothing more."""
    assert (mesh.world_size(), mesh.rank(), mesh.is_primary(), mesh.in_group()) == (1, 0, True, False)
    x = torch.randn(4, 3, requires_grad=True)
    assert mesh.gather_rows(x) is x
    bn, xb = BatchNorm(3).train(), torch.randn(2, 3, 4, 4)
    with global_batch_stats():
        y = bn(xb, update_stats=False)
    assert torch.equal(y, bn(xb, update_stats=False))
    a, b = torch.ones(2), torch.zeros(3, dtype=torch.bool)
    assert mesh.fetch(a) is a and mesh.fetch(a, b) == (a, b)
    (x * 2).sum().backward()
    g = x.grad.clone()
    mesh.reset_collectives()
    mesh.all_reduce_grads([x])
    assert torch.equal(x.grad, g) and mesh.collectives == 0
    assert not mesh.rows_sharded(8) and mesh.local_rows(8) == slice(None)


def _flax_fold(x, momentum=0.1):
    """flax's running statistics after one fold from (0, 1): the biased
    variance as E[x^2] - E[x]^2, in x's dtype."""
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    return momentum * mean, (1 - momentum) + momentum * var


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("global_stats", [False, True])
def test_world_of_one_batch_norm_is_f_batch_norm(dtype, global_stats):
    """At world size 1 a train-mode BatchNorm, inside ``global_batch_stats``
    or not, gives ``F.batch_norm``'s output and gradients on a channels_last
    batch within its dtype's rounding, folds flax's biased-variance running
    statistics, and runs no collective."""
    gen = torch.Generator().manual_seed(5)
    x0 = (torch.randn(3, 6, 5, 7, generator=gen, dtype=dtype) * 2
          + torch.arange(6, dtype=dtype).view(1, 6, 1, 1) - 2)
    gy = torch.randn(x0.shape, generator=gen, dtype=dtype)
    w0, b0 = (torch.randn(6, generator=gen, dtype=dtype) for _ in range(2))
    x, xr = (x0.clone().contiguous(memory_format=torch.channels_last).requires_grad_()
             for _ in range(2))
    bn = BatchNorm(6).to(dtype).train()
    with torch.no_grad():
        bn.weight.copy_(w0)
        bn.bias.copy_(b0)
    wr, br = w0.clone().requires_grad_(), b0.clone().requires_grad_()
    mesh.reset_collectives()
    with global_batch_stats(global_stats):
        y = bn(x)
        (y * gy).sum().backward()
    assert mesh.collectives == 0
    yr = F.batch_norm(xr, None, None, wr, br, True, 0.0, bn.eps)
    (yr * gy).sum().backward()
    assert y.dtype == dtype and y.is_contiguous(memory_format=torch.channels_last)
    for got, want in ((y, yr), (x.grad, xr.grad), (bn.weight.grad, wr.grad),
                      (bn.bias.grad, br.grad)):
        torch.testing.assert_close(got, want)
    mean, var = _flax_fold(x0)
    torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-6)
