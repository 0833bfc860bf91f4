"""The train steps' per-step scalars as device inputs, and their replay as
one CUDA graph (``aide_tpu_torch.engine.graphs``).

On the CPU:
- every optimizer option (with and without clipping and weight decay)
  takes its per-step scalars as 0-dim tensors (``given``), and
  updates bit for bit as it does from the floats it computes itself;
- 3 co-teaching and 3 supervised steps with the scalars as one f32 device
  vector give, bit for bit, the losses, dice sums, count, parameters, BN
  running stats, AMSGrad moments and step count of the steps given the
  Python floats the step multiplied by before (``device_scalars`` replaced
  by the floats themselves), with the co-teaching rate and the PolyLR
  rate changing every step;
- the replay rule: eager on the CPU, over more than one process, for a
  ``NetRankState``, under ``FlopCounterMode`` and inside a running
  capture; replayable on a card otherwise; each eager step counts one
  ``train.graph_eager``.

On a card (``cuda``-marked, skipped without one): 9 steps of the
co-teaching pair (FuseUNet, train-mode views; and a single-modal UNet
pair whose eval-mode views read the running statistics, as the kidney
cell runs it), the warp kernel, bf16, and of the supervised UNet,
replayed against eager from the same weights and inputs: 2 eager steps,
the capture, 6 replays, across a change of the rate and a
``restore_state_tree`` of the state that 5 steps left; every step's
metrics, the parameters, BN running stats, moments bit for bit, the
optimizer's count, the graph counters, the warp kernel's host-called
launches and, from a profiler trace of 4 replayed steps, the warp kernels
the card ran. At the kidney cell's width (UNet-64, 512 px, batch 8) the
replay lies within twice the eager runs' own difference. The train-mode
BatchNorm the steps run, at the first norm of each cell's net under bf16
autocast, equals ``F.batch_norm`` forward and backward within the
rounding of each dtype, with no collective, and folds flax's running
statistics within rtol 1e-5.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from aide_tpu_torch.core import mesh, trace
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import graphs, steps
from aide_tpu_torch.engine.state import DualTrainState, NetRankState, TrainState
from aide_tpu_torch.engine.trainer import init_net
from aide_tpu_torch.models import blocks
from aide_tpu_torch.ops import tta
from aide_tpu_torch.ops.schedules import make_optimizer

B, V = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(dual: bool, size: int, dtype: str) -> TrainConfig:
    cfg = TrainConfig()
    cfg.model.name = "fuseunet" if dual else "unet"
    cfg.model.base_width = 4
    cfg.model.compute_dtype = dtype
    cfg.data.img_size = size
    cfg.data.batch_size = B
    cfg.data.num_tta_views = V
    cfg.optim.lr_policy = "PolyLR"
    return cfg


def _state(cfg: TrainConfig, dual: bool, device):
    """Nets from seeds 0 (and 1), one optimizer whose PolyLR rate changes
    every step (one step an epoch)."""
    nets = [init_net(cfg.model, seed).to(device, memory_format=torch.channels_last)
            for seed in ((0, 1) if dual else (0,))]
    opt = make_optimizer([p for n in nets for p in n.parameters()], cfg.optim, 1, 20)
    return DualTrainState(*nets, opt) if dual else TrainState(nets[0], opt)


def _batch(dual: bool, size: int, seed: int, device, two_modal=None, b: int = B):
    """A batch of ``b`` images, of two modalities where ``two_modal`` (by
    default: a pair of nets), with one target, or two for a pair."""
    two_modal = dual if two_modal is None else two_modal
    rng = np.random.default_rng(seed)
    out = {}
    for m in (("1", "2") if two_modal else ("",)):
        out[f"modal{m}" if two_modal else "image"] = rng.integers(0, 256, (b, size, size, 3),
                                                                  dtype=np.uint8)
        out[f"scale{m}"] = rng.uniform(0.01, 0.03, (b, 3)).astype(np.float32)
        out[f"fill{m}"] = rng.uniform(-2.5, -0.5, (b, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for t in (("target1", "target2") if dual else ("target",)):
        cy, cx = rng.uniform(0.25, 0.75, 2) * size
        r = rng.uniform(0.1, 0.3) * size
        base = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.int64)
        out[t] = np.stack([np.roll(base, int(rng.integers(-3, 4)), axis=1) for _ in range(b)])
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _args(dual: bool, size: int, i: int, rate: float, device, two_modal=None, b: int = B,
          views: int = V):
    batch = _batch(dual, size, 10 + i, device, two_modal, b)
    if not dual:
        return (batch,)
    gen = torch.Generator().manual_seed(100 + i)
    degrees, hflip = tta.sample_view_params(gen, views, b, 60.0, 0.5)
    return batch, degrees.to(device), hflip.to(device), rate


def _leaves(state):
    """Every tensor the step updates, by name, as copies."""
    out = {}
    for k, net in enumerate(state.nets):
        for name, t in net.state_dict().items():
            out[f"net{k}.{name}"] = t.detach().clone()
        for name, p in net.named_parameters():
            for m in state.optimizer.MOMENTS:
                out[f"net{k}.{name}.{m}"] = state.optimizer.state[p][m].clone()
    return out


RATES = (0.0, 0.3, 0.7)


# ----------------------------- the CPU -----------------------------


@pytest.mark.parametrize("clip,decay", [(None, 0.0), (0.5, 1e-4)])
@pytest.mark.parametrize("name", ["amsgrad_adam", "adam", "sgd"])
def test_tensor_scalars_update_as_the_floats_bit_for_bit(name, clip, decay):
    cfg = TrainConfig().optim
    cfg.optimizer, cfg.grad_clip_norm, cfg.weight_decay = name, clip, decay
    cfg.lr_policy = "PolyLR"
    gen = torch.Generator().manual_seed(3)
    shapes = [(3, 5), (7,), (2, 3, 4)]
    pairs = []
    for _ in range(2):
        params = [torch.nn.Parameter(torch.randn(s, generator=torch.Generator().manual_seed(9)))
                  for s in shapes]
        pairs.append((params, make_optimizer(params, cfg, 1, 10)))
    for _ in range(5):
        grads = [torch.randn(s, generator=gen) * 10 for s in shapes]
        for k, (params, opt) in enumerate(pairs):
            for p, g in zip(params, grads):
                p.grad = g.clone()
            if k:
                opt.given = graphs.device_scalars(opt.hyper(), torch.device("cpu"))
            opt.step()
            assert opt.given is None
    (p0, o0), (p1, o1) = pairs
    assert o0.count == o1.count == 5
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
        for m in o0.MOMENTS:
            assert torch.equal(o0.state[a][m], o1.state[b][m])


def _steps(dual: bool, floats: bool, monkeypatch):
    cfg = _cfg(dual, 32, "float32")
    state = _state(cfg, dual, "cpu")
    step = (steps.make_coteach_train_step(True, cfg) if dual
            else steps.make_supervised_train_step(False, cfg))
    with monkeypatch.context() as m:
        if floats:
            m.setattr(graphs, "device_scalars", lambda values, device: tuple(values))
        metrics = [step(state, *_args(dual, 32, i, RATES[i], "cpu")) for i in range(3)]
    return metrics, _leaves(state), state.optimizer.count


@pytest.mark.parametrize("dual", [True, False], ids=["coteach", "supervised"])
def test_device_scalars_step_as_the_floats_bit_for_bit(dual, monkeypatch):
    (m_t, leaves_t, count_t), (m_f, leaves_f, count_f) = (
        _steps(dual, floats, monkeypatch) for floats in (False, True))
    assert count_t == count_f == 3
    for a, b in zip(m_t, m_f):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert float(m_t[0]["count"]) == B
    assert leaves_t.keys() == leaves_f.keys()
    for k in leaves_t:
        assert torch.equal(leaves_t[k], leaves_f[k]), k


def _cuda_stand_in(monkeypatch, capturing=False):
    """What ``replayable`` reads of a card, on a host without one."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    return torch.device("cuda")


def test_the_rule_replays_one_process_on_a_card(monkeypatch):
    cfg = _cfg(True, 32, "float32")
    state = _state(cfg, True, "cpu")
    card = _cuda_stand_in(monkeypatch)
    assert graphs.replayable(state, card)
    assert graphs.replayable(TrainState(state.nets[0], state.optimizer), card)
    assert not graphs.replayable(state, torch.device("cpu"))


@pytest.mark.parametrize("case", ["data", "space", "net_rank", "flop_counter", "capturing"])
def test_the_rule_keeps_the_step_eager(case, monkeypatch):
    cfg = _cfg(True, 32, "float32")
    state = _state(cfg, True, "cpu")
    card = _cuda_stand_in(monkeypatch, capturing=case == "capturing")
    if case in ("data", "space"):
        # two ranks of a data axis, or of a space axis: a process group
        monkeypatch.setattr(mesh, "world_size", lambda: 2)
    if case == "net_rank":
        state = NetRankState(state.nets[0], 0, state.optimizer)
    if case == "flop_counter":
        with FlopCounterMode(display=False):
            assert not graphs.replayable(state, card)
    else:
        assert not graphs.replayable(state, card)


@pytest.mark.parametrize("flops", [False, True], ids=["plain", "flop_counter"])
@pytest.mark.parametrize("dual", [True, False], ids=["coteach", "supervised"])
def test_a_cpu_step_runs_eagerly_and_counts_it(dual, flops):
    cfg = _cfg(dual, 32, "float32")
    state = _state(cfg, dual, "cpu")
    step = (steps.make_coteach_train_step(True, cfg) if dual
            else steps.make_supervised_train_step(False, cfg))
    before = trace.totals()
    for i in range(2):
        if flops:
            with FlopCounterMode(display=False) as counter:
                step(state, *_args(dual, 32, i, 0.5, "cpu"))
            assert counter.get_total_flops() > 0
        else:
            step(state, *_args(dual, 32, i, 0.5, "cpu"))
    spent = trace.delta(before)
    assert spent["train.graph_eager"] == 2
    assert "train.graph_replays" not in spent and "train.graph_captures" not in spent
    # eager steps close their own spans
    assert spent["step.optimizer"][1] == spent["train.step"][1] == 2
    assert state.optimizer.count == 2


def test_the_count_is_one_constant_a_batch_size():
    a = steps.batch_count(B, torch.device("cpu"))
    assert a is steps.batch_count(B, torch.device("cpu"))
    assert a.dtype == torch.float32 and float(a) == B
    assert float(steps.batch_count(B + 1, torch.device("cpu"))) == B + 1


# ----------------------------- a card -----------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the co-teaching pair as the CHAOS cell runs it (FuseUNet, train-mode
# views), and as the kidney cell does (a single-modal UNet pair, eval-mode
# views that read the running statistics the steps before them folded in,
# p^(1/T) sharpening); the supervised UNet
KINDS = {"coteach": (True, True, "batch"), "supervised": (False, False, "batch"),
         "coteach_running": (True, False, "running")}


def _kind_cfg(kind: str, size: int, width: int, b: int = B, views: int = V) -> TrainConfig:
    dual, two_modal, tta_bn = KINDS[kind]
    cfg = _cfg(dual, size, "bfloat16")
    cfg.model.name = "fuseunet" if two_modal else "unet"
    cfg.model.base_width = width
    cfg.data.batch_size, cfg.data.num_tta_views = b, views
    cfg.coteach.tta_bn = tta_bn
    if tta_bn == "running":
        cfg.coteach.sharpen_mode = "pow_inv_t"
    return cfg


def _run_on_card(kind: str, replay: bool, device, monkeypatch, size: int = 64, width: int = 8,
                 b: int = B, views: int = V):
    """9 steps: rate 0.2 for 4 steps, then 0.9 (the replays from step 5
    read the new rate); the state after step 5 written to the host and
    restored in place after step 7. Steps 5-8 run under torch.profiler:
    the warp kernels the card ran in them, by CUPTI's kernel records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dual, two_modal, _ = KINDS[kind]
    cfg = _kind_cfg(kind, size, width, b, views)
    state = _state(cfg, dual, device)
    step = (steps.make_coteach_train_step(two_modal, cfg) if dual
            else steps.make_supervised_train_step(False, cfg))
    metrics, tree = [], None
    before = trace.totals()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with monkeypatch.context() as m:
        if not replay:
            m.setattr(graphs, "replayable", lambda state, device: False)
        for i in range(9):
            if i == 5:
                torch.cuda.synchronize()
                prof.start()
            if i == 7:
                ckpt.restore_state_tree(state, tree)
            out = step(state, *_args(dual, size, i, 0.2 if i < 4 else 0.9, device, two_modal,
                                     b, views))
            metrics.append({k: v.float().cpu() for k, v in out.items()})
            if i == 4:
                tree = ckpt.state_tree(state)
    torch.cuda.synchronize()
    prof.stop()
    ran = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
              and "warp_rotate_flip_kernel" in e.name)
    leaves = {k: v.cpu() for k, v in _leaves(state).items()}
    return metrics, leaves, state.optimizer.count, trace.delta(before), ran


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_replay_equals_eager_on_the_card(cuda_device, kind, monkeypatch):
    eager = _run_on_card(kind, False, cuda_device, monkeypatch)
    replayed = _run_on_card(kind, True, cuda_device, monkeypatch)
    (m_e, leaves_e, count_e, spent_e, ran_e), (m_r, leaves_r, count_r, spent_r, ran_r) = (
        eager, replayed)
    # 5 steps, back to the count of 5 steps, 2 more
    assert count_e == count_r == 7
    assert spent_e["train.graph_eager"] == 9 and "train.graph_replays" not in spent_e
    assert spent_r.get("train.graph_eager") == 2
    assert spent_r.get("train.graph_captures") == 1
    assert spent_r.get("train.graph_replays") == 6
    # the host calls the kernel in the eager steps and the capture; the
    # graph launches it in the replays, and the profiled steps 5-8 ran it
    # once a modality and once for the views' logits a step either way
    dual, two_modal, _ = KINDS[kind]
    per_step = (3 if two_modal else 2) if dual else 0
    assert spent_e.get("warp.launches", 0) == 9 * per_step
    assert spent_r.get("warp.launches", 0) == 3 * per_step
    assert ran_e == ran_r == 4 * per_step
    for i, (a, b) in enumerate(zip(m_e, m_r)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(b[k], a[k]), (i, k, float((a[k] - b[k]).abs().max()))
    assert leaves_e.keys() == leaves_r.keys()
    for k in leaves_e:
        a, b = leaves_e[k], leaves_r[k]
        assert torch.equal(b, a), (k, float((a.float() - b.float()).abs().max()))


def _apart(x, y) -> tuple:
    """The largest element gap of two runs' metrics and of their leaves."""
    (m_x, l_x, *_), (m_y, l_y, *_) = x, y
    metrics = max(float((a[k] - b[k]).abs().max()) for a, b in zip(m_x, m_y) for k in a)
    leaves = max(float((l_x[k].float() - l_y[k].float()).abs().max()) for k in l_x)
    return metrics, leaves


@pytest.mark.cuda
def test_replay_within_eager_spread_at_the_kidney_cell_width(cuda_device, monkeypatch):
    """The kidney cell's step (UNet-64 pair, 512 px, batch 8, 4 views,
    bf16, eval-mode views) over ``_run_on_card``'s 9 steps: two eager runs
    and a replayed one from the same weights and inputs. At this width
    cuDNN's kernels are not bitwise repeatable from run to run, so the
    replay has to lie within twice the eager runs' own difference of the
    nearer eager run (exact where the eager runs are)."""
    runs = []
    for replay in (False, False, True):
        runs.append(_run_on_card("coteach_running", replay, cuda_device, monkeypatch, size=512,
                                 width=64, b=8, views=4))
        gc.collect()
        torch.cuda.empty_cache()
    spread = _apart(runs[0], runs[1])
    gap = min((_apart(runs[2], e) for e in runs[:2]), key=lambda g: g[1])
    print(f"eager runs apart (metrics, leaves): {spread}; the replay from the nearer: {gap}")
    assert runs[2][3].get("train.graph_replays") == 6
    assert [r[4] for r in runs] == [8, 8, 8]  # 2 warp kernels in each of 4 profiled steps
    for g, s in zip(gap, spread):
        assert g <= 2 * s, (gap, spread)


# the first train-mode BatchNorm of each cell's net, batch 8: the CHAOS
# cell's FuseUNet-32 at 256 px and the kidney cell's UNet-64 at 512 px
BN_SHAPES = {"chaos": (8, 32, 256, 256), "kidney": (8, 64, 512, 512)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(BN_SHAPES))
def test_batch_norm_is_f_batch_norm_on_the_card(cuda_device, cell):
    """The train-mode BatchNorm the steps run (``blocks.BatchNorm``: torch's
    per-channel statistics and normalise kernels, no collective on one
    rank) against ``F.batch_norm`` on the same bf16 channels_last batch
    under autocast: the statistics (against ``torch.native_batch_norm``'s
    saved mean and inverse std), y, dx, dweight and dbias each within its
    dtype's rounding (``assert_close``'s defaults), the largest
    differences printed; and its running statistics within rtol 1e-5 of
    flax's fold, E[x^2] - E[x]^2 in f32, of the same batch."""
    n, c, h, w = BN_SHAPES[cell]
    gen = torch.Generator(device=cuda_device).manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)

    x0 = (randn(n, c, h, w) * 2 + randn(c).view(1, c, 1, 1)).to(torch.bfloat16)
    x0 = x0.contiguous(memory_format=torch.channels_last)
    gy = randn(n, c, h, w).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w0, b0 = randn(c), randn(c)
    bn = blocks.BatchNorm(c).to(cuda_device).train()
    with torch.no_grad():
        bn.weight.copy_(w0)
        bn.bias.copy_(b0)
    x, xr = (x0.clone().requires_grad_() for _ in range(2))
    wr, br = w0.clone().requires_grad_(), b0.clone().requires_grad_()
    mesh.reset_collectives()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = bn(x)
        yr = F.batch_norm(xr, None, None, wr, br, True, 0.0, bn.eps)
    y.backward(gy)
    yr.backward(gy)
    assert mesh.collectives == 0
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    stats = torch.batch_norm_stats(x0, bn.eps)
    _, *native = torch.native_batch_norm(x0, w0, b0, None, None, True, 0.0, bn.eps)
    pairs = {"mean": (stats[0], native[0]), "invstd": (stats[1], native[1]), "y": (y, yr),
             "dx": (x.grad, xr.grad), "dweight": (bn.weight.grad, wr.grad),
             "dbias": (bn.bias.grad, br.grad)}
    gaps = {name: float((got.detach().float() - want.detach().float()).abs().max())
            for name, (got, want) in pairs.items()}
    print(f"{cell}: largest differences from F.batch_norm {gaps}")
    for got, want in pairs.values():
        torch.testing.assert_close(got, want)
    xf = x0.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
