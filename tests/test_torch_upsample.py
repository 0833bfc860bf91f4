"""The decoders' 2x bilinear upsample (``aide_tpu_torch.ops.cuda_upsample``,
``csrc/upsample2x.cu``).

On the CPU: the plain versions (what the wrapper runs for a CPU tensor)
against ``F.interpolate`` (bilinear, half-pixel, scale 2) and its backward
in f32 and f64 at C in {1, 3, 4, 6, 64}, H != W and H = 1;
``torch.autograd.gradcheck`` of the Function in f64; bit for bit against
autocast's path after the cast to bf16 at the kidney cell's four decoder
levels cut to 2 images (one-ulp ties counted and printed); the
space-partitioned path against the whole image's rows; ``F.interpolate``
while ``torch.export`` traces; the dtypes and memory format out; the
vector widths; the models' routing; the refusals of the kernel path for
a CPU or meta tensor and without nvcc; and ``upsample.launches``.

On a card (``cuda``-marked, skipped without one): the kernels bit for bit
against their plain versions, forward and backward, bf16 and f32, at the
kidney and CHAOS cells' launch shapes and the edge cases, inside
autocast, and inside a captured and replayed CUDA graph. This file does
not import JAX: ``python -m pytest tests/test_torch_upsample.py -m cuda``
runs where only PyTorch is installed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aide_tpu_torch.core import trace
from aide_tpu_torch.models import blocks
from aide_tpu_torch.ops import cuda_upsample, nvcc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (N, C, H, W): C in {1, 3, 4, 6, 64}, H != W, H = 1, W = 1
SHAPES = [(2, 1, 5, 7), (2, 3, 7, 5), (2, 4, 1, 6), (1, 6, 6, 1), (2, 64, 4, 4), (3, 6, 9, 5),
          (1, 3, 1, 1)]
# the kidney cell's decoder inputs (UNet-64, 512 px), cut to 2 images, and
# the CHAOS cell's (FuseUNet-32's fused maps, 256 px)
KIDNEY_LEVELS = [(2, 1024 >> k, 32 << k, 32 << k) for k in range(4)]
CHAOS_LEVELS = [(2, 1024 >> k, 16 << k, 16 << k) for k in range(4)]


def _randn(shape, dtype=torch.float32, seed=0, device="cpu"):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))
    return x.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def _library(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def launches() -> int:
    return trace.totals().get("upsample.launches", 0)


# ----------------------------- the CPU -----------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-14)])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_interpolate(shape, dtype, tol):
    x = _randn(shape, dtype, seed=1).requires_grad_(True)
    ref = _library(x)
    g = _randn(ref.shape, dtype, seed=2)
    (gx_ref,) = torch.autograd.grad(ref, x, g)
    out = cuda_upsample.upsample2x(x)
    (gx,) = torch.autograd.grad(out, x, g)
    out, ref = out.detach(), ref.detach()
    assert out.dtype == gx.dtype == dtype
    assert out.shape == ref.shape and gx.shape == x.shape
    assert float((out - ref).abs().max()) <= tol
    assert float((gx - gx_ref).abs().max()) <= 4 * tol


@pytest.mark.parametrize("shape", SHAPES)
def test_gradcheck_f64(shape):
    x = _randn(shape, torch.float64, seed=3).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: cuda_upsample.Upsample2x.apply(t, torch.float64),
                                    (x,))


@pytest.mark.parametrize("level", range(4))
def test_bf16_equals_autocast_path_at_kidney_levels(level):
    """bf16 in, bf16 out: the autocast path's operand to the next conv,
    ``bf16(f32 interpolate of the bf16 input)``. Differences can only be
    one-ulp ties of the two f32 sums' last bits; none is allowed here, and
    the count is printed."""
    x = _randn(KIDNEY_LEVELS[level], torch.bfloat16, seed=4 + level)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = blocks.upsample2x_bilinear(x)
    ref = _library(x.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    differ = got != ref
    ulp = (got.float() - ref.float()).abs()[differ]
    print(f"level {level} {tuple(x.shape)}: {int(differ.sum())} of {got.numel()} differ "
          f"(largest {float(ulp.max()) if ulp.numel() else 0.0})")
    assert int(differ.sum()) == 0


@pytest.mark.parametrize("shards", [2, 4])
def test_space_partitioned_path_equals_the_whole_rows(shards, monkeypatch):
    """Each shard's rows with one halo row of each neighbour (the edge row
    copied at the image's top and bottom), upsampled and cropped to [2,
    2h + 2), against the whole image's output rows and, summed over the
    shards, its gradient (f64: the top edge row is 0.25a + 0.75a where the
    whole image's is 1a + 0a)."""
    x = _randn((2, 3, 16, 6), torch.float64, seed=5).requires_grad_(True)
    whole = cuda_upsample.upsample2x(x)
    g = _randn(whole.shape, torch.float64, seed=6)
    (gx_whole,) = torch.autograd.grad(whole, x, g)
    h = x.shape[2] // shards
    rank = {"s": 0}

    def halo_rows(part, r, edge=False):
        assert r == 1 and edge
        s = rank["s"]
        rows = torch.arange(s * h - 1, (s + 1) * h + 1).clamp(0, x.shape[2] - 1)
        return x.index_select(2, rows)

    monkeypatch.setattr(blocks, "_partitioned", lambda: True)
    monkeypatch.setattr(blocks.mesh, "halo_rows", halo_rows)
    parts = []
    for s in range(shards):
        rank["s"] = s
        parts.append(blocks.upsample2x_bilinear(x[:, :, s * h:(s + 1) * h]))
    out = torch.cat(parts, dim=2)
    (gx,) = torch.autograd.grad(out, x, g)
    out, whole = out.detach(), whole.detach()
    assert out.shape == whole.shape
    assert float((out - whole).abs().max()) <= 1e-14
    assert torch.equal(out[:, :, 1:], whole[:, :, 1:])
    assert float((gx - gx_whole).abs().max()) <= 1e-14


def test_export_takes_interpolate(monkeypatch):
    x = _randn((2, 4, 5, 6), seed=7)

    def refuse(t):
        raise AssertionError("the package's upsample called while exporting")

    monkeypatch.setattr(cuda_upsample, "upsample2x", refuse)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert torch.equal(blocks.upsample2x_bilinear(x), _library(x))


def test_exported_program_holds_aten_upsample():
    x = _randn((2, 4, 5, 6), seed=8)
    program = torch.export.export(blocks.Upsample2x(), (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert any("upsample_bilinear2d" in t for t in targets), targets
    assert torch.equal(program.module()(x), _library(x))


@pytest.mark.parametrize("din,autocast,dout", [
    (torch.float32, None, torch.float32), (torch.bfloat16, None, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float64, torch.bfloat16, torch.float64), (torch.float16, None, torch.float16)])
def test_output_dtype_and_memory_format(din, autocast, dout):
    x = _randn((2, 6, 5, 4), din, seed=9).contiguous().requires_grad_(True)
    with torch.autocast("cpu", dtype=autocast or torch.bfloat16, enabled=autocast is not None):
        out = cuda_upsample.upsample2x(x)
    assert out.dtype == dout
    assert out.is_contiguous(memory_format=torch.channels_last)
    (gx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert gx.dtype == din and gx.shape == x.shape
    # f32 sums rounded once: the plain version at the output's dtype
    ref = cuda_upsample.upsample2x_plain(x.detach().permute(0, 2, 3, 1), dout)
    assert torch.equal(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("c,dtypes,offset,vec", [
    (64, (torch.bfloat16, torch.bfloat16), 0, 8), (64, (torch.float32, torch.float32), 0, 4),
    (64, (torch.float32, torch.bfloat16), 0, 4), (6, (torch.bfloat16, torch.bfloat16), 0, 2),
    (3, (torch.bfloat16, torch.float32), 0, 1), (4, (torch.float32, torch.float32), 0, 4),
    (64, (torch.bfloat16, torch.bfloat16), 1, 1), (64, (torch.float32, torch.float32), 2, 2)])
def test_vector_width(c, dtypes, offset, vec):
    tensors = [torch.empty(64 * c + 64, dtype=d)[offset if k == 0 else 0:] for k, d in
               enumerate(dtypes)]
    # an allocation's base is at least 16-byte aligned
    assert all(t.data_ptr() % 16 == (offset * t.element_size() if k == 0 else 0)
               for k, t in enumerate(tensors))
    assert cuda_upsample.vector_width(c, *tensors) == vec


@pytest.mark.parametrize("name", ["unet4", "unetsa", "fuseunet", "fuseunetsa",
                                  "fuseunetsaseparate"])
def test_models_route_through_the_function(name, monkeypatch):
    from aide_tpu_torch.core.config import TrainConfig
    from aide_tpu_torch.engine.trainer import init_net

    cfg = TrainConfig()
    cfg.model.name, cfg.model.base_width, cfg.model.compute_dtype = name, 2, "float32"
    net = init_net(cfg.model, 0)
    calls = []
    real = cuda_upsample.Upsample2x.apply

    def counted(x, dtype):
        calls.append(tuple(x.shape))
        return real(x, dtype)

    monkeypatch.setattr(cuda_upsample.Upsample2x, "apply", counted)
    images = [_randn((2, 32, 32, 3), seed=10 + m).contiguous()
              for m in range(2 if name.startswith("fuse") else 1)]
    logits = net(*images)
    logits.sum().backward()
    assert len(calls) == 4, calls  # the four decoder levels
    assert [s[2] for s in calls] == [2, 4, 8, 16]


def test_learned_upsample_bypasses_it(monkeypatch):
    from aide_tpu_torch.core.config import TrainConfig
    from aide_tpu_torch.engine.trainer import init_net

    cfg = TrainConfig()
    cfg.model.name, cfg.model.base_width, cfg.model.compute_dtype = "unet4", 2, "float32"
    cfg.model.learned_bilinear = True
    net = init_net(cfg.model, 0)

    def refuse(x, dtype):
        raise AssertionError("the learned upsample called the bilinear one")

    monkeypatch.setattr(cuda_upsample.Upsample2x, "apply", refuse)
    assert net(_randn((2, 32, 32, 3), seed=12).contiguous()).shape == (2, 32, 32, 2)


def test_kernel_path_refuses_cpu_and_meta_tensors():
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_upsample.launch_forward(x, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_upsample.launch_backward(torch.zeros((1, 8, 8, 8)), torch.float32)
    with pytest.raises(ValueError, match="no path for device meta"):
        cuda_upsample.upsample2x(torch.zeros((1, 8, 4, 4), device="meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(nvcc, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    monkeypatch.setattr(nvcc, "NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_upsample.build()


def test_kernel_source_has_the_entry_points():
    with open(cuda_upsample.SOURCE) as fh:
        src = fh.read()
    for name in ("upsample2x_forward", "upsample2x_backward", "upsample2x_fwd_kernel",
                 "upsample2x_bwd_kernel"):
        assert name in src
    assert "-fmad=false" in cuda_upsample.NVCC_FLAGS


def test_launch_counter_does_not_move_on_cpu_tensors():
    x = _randn((2, 4, 5, 6), seed=13).requires_grad_(True)
    before = trace.totals()
    cuda_upsample.upsample2x(x).sum().backward()
    assert "upsample.launches" not in trace.delta(before)


def test_bytes_moved():
    assert cuda_upsample.bytes_moved((8, 32, 32, 1024), 2, 2) == 8 * 32 * 32 * 1024 * 2 * 5
    assert cuda_upsample.bytes_moved((1, 2, 3, 4), 4, 2) == 24 * 4 + 96 * 2


# ----------------------------- a card -----------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_equals_plain(x, out_dtype, seed):
    """Forward and backward through the Function on the card, against the
    plain versions on the same tensors, bit for bit; two launches."""
    xin = x.detach().requires_grad_(True)
    before = launches()
    out = cuda_upsample.Upsample2x.apply(xin, out_dtype)
    g = _randn(out.shape, out_dtype, seed, x.device)
    (gx,) = torch.autograd.grad(out, xin, g)
    assert launches() == before + 2
    nhwc = x.permute(0, 2, 3, 1)
    ref = cuda_upsample.upsample2x_plain(nhwc, out_dtype)
    g_ref = cuda_upsample.upsample2x_grad_plain(g.permute(0, 2, 3, 1), x.dtype)
    torch.cuda.synchronize()
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out.permute(0, 2, 3, 1), ref)
    assert gx.dtype == x.dtype
    assert torch.equal(gx.permute(0, 2, 3, 1), g_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8,) + s[1:] for s in KIDNEY_LEVELS + CHAOS_LEVELS])
def test_cuda_kernels_equal_plain_at_the_cells_shapes(cuda_device, shape, dtype):
    _kernel_equals_plain(_randn(shape, dtype, 20, cuda_device), dtype, 21)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                                    (torch.float16, torch.float16),
                                    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_equal_plain_at_the_edges(cuda_device, shape, dtypes):
    din, dout = dtypes
    _kernel_equals_plain(_randn(shape, din, 22, cuda_device), dout, 23)


@pytest.mark.cuda
def test_cuda_kernels_under_autocast(cuda_device):
    x = _randn((8, 256, 32, 32), torch.float32, 24, cuda_device)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        out = blocks.upsample2x_bilinear(x)
    assert out.dtype == torch.bfloat16
    ref = cuda_upsample.upsample2x_plain(x.permute(0, 2, 3, 1), torch.bfloat16)
    assert torch.equal(out.permute(0, 2, 3, 1), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_kernels_in_a_replayed_graph(cuda_device, dtype):
    """Forward and backward captured in one CUDA graph with static inputs;
    three replays on new values, each bit for bit against the plain
    versions; the host calls the kernels only in the warm-up and the
    capture."""
    shape = (8, 128, 64, 64)
    x = _randn(shape, dtype, 25, cuda_device).requires_grad_(True)
    g = _randn((8, 128, 128, 128), dtype, 26, cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            (gx,) = torch.autograd.grad(cuda_upsample.upsample2x(x), x, g)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_upsample.upsample2x(x)
        (gx,) = torch.autograd.grad(out, x, g)
    before = launches()
    for seed in (27, 28, 29):
        with torch.no_grad():
            x.copy_(_randn(shape, dtype, seed, cuda_device))
            g.copy_(_randn(g.shape, dtype, seed + 10, cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        ref = cuda_upsample.upsample2x_plain(x.detach().permute(0, 2, 3, 1), dtype)
        g_ref = cuda_upsample.upsample2x_grad_plain(g.permute(0, 2, 3, 1), dtype)
        assert torch.equal(out.permute(0, 2, 3, 1), ref)
        assert torch.equal(gx.permute(0, 2, 3, 1), g_ref)
    assert launches() == before
