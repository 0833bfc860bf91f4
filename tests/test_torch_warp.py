"""The port's warps against the JAX package's (max abs <= 1e-5, the bar of
tests/test_pallas_warp.py).

The port's shear path and the CUDA kernel's plain version (what the kernel
wrapper runs for a CPU tensor) against the JAX shear path over degrees
{0, ±23, ±45, ±52, ±60, 90} with flips on and off, scalar / (C,) / (B, C)
fills and C in {1, 2, 3}, in both directions; the plain version also
against the Pallas kernel itself in interpret mode, and both the plain
version and the shear path against it past ±180 degrees (the JAX package
takes any angle), up to ±720. The kernel stages each 32 x 32 output
tile's source box in shared memory where it is at most BOX_SIDE on a side,
and reads a larger box's taps from device memory: the CPU cases hold every
tile's exact box (source_boxes, the plain version's index math) to that
bound over ±180 degrees, check that the box holds every tap the tile
reads, and that over ±720 degrees global_tiles counts exactly the tiles
whose box passes it. Cuda-marked cases hold the CUDA kernel to its plain
version on a card, exactly past ±180 degrees.

The JAX package is imported inside the tests that use it, so the file also
runs where only PyTorch is installed: there the cuda-marked cases run and
the JAX comparisons skip (python -m pytest tests/test_torch_warp.py -m cuda).
"""

import re

import numpy as np
import pytest
import torch

from aide_tpu_torch.core import trace
from aide_tpu_torch.ops import cuda_warp, warp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DEGS = np.array([0.0, 23.0, -23.0, 45.0, -45.0, 52.0, -52.0, 60.0, -60.0, 90.0], np.float32)
# where the residual angle, the rot90 or the shear coefficients change regime
BOUNDARY_DEGS = np.array([44.9, 45.0, 45.1, -44.9, -45.0, -45.1, 135.0, -135.0, 180.0, -180.0],
                         np.float32)


# past ±180 degrees, the angles of chip_smoke.py's phase 3: the kernel's
# global-tap path from ±217.5 degrees at 256 px, a tile's box the whole
# image near ±270, every box within BOX_SIDE again from ±300
WIDE_DEGS = np.array([180.0, 200.0, 217.5, 230.0, 250.0, 265.0, 269.5, 269.99, 270.0, 300.0,
                      360.0, 540.0, 720.0], np.float32)
WIDE_DEGS = np.concatenate([WIDE_DEGS, -WIDE_DEGS])


def launches() -> int:
    """The warp kernel's launches so far (the port's ``warp.launches``)."""
    return trace.totals().get("warp.launches", 0)


def _inputs(c, fill_kind, size=32, seed=0):
    rng = np.random.default_rng(seed)
    degrees = np.concatenate([DEGS, DEGS])
    hflip = np.repeat(np.array([0.0, 1.0], np.float32), len(DEGS))
    b = len(degrees)
    images = rng.normal(size=(b, size, size, c)).astype(np.float32)
    fill = {
        "scalar": np.float32(rng.normal()),
        "channel": rng.normal(size=(c,)).astype(np.float32),
        "image": rng.normal(size=(b, c)).astype(np.float32),
    }[fill_kind]
    return images, degrees, hflip, fill


def _jax_warp():
    pytest.importorskip("jax")
    from aide_tpu.ops import warp as jwarp

    return jwarp


def _jax(fn, images, degrees, hflip, fill, method):
    import jax.numpy as jnp

    return np.asarray(fn(jnp.asarray(images), jnp.asarray(degrees), jnp.asarray(hflip),
                         jnp.asarray(fill), method=method))


def _port(fn, images, degrees, hflip, fill, method):
    return fn(torch.from_numpy(images), torch.from_numpy(degrees), torch.from_numpy(hflip),
              torch.as_tensor(fill), method=method).numpy()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fill_kind", ["scalar", "channel", "image"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_port_warps_match_jax_shear(c, fill_kind, inverse):
    images, degrees, hflip, fill = _inputs(c, fill_kind, seed=c)
    jwarp = _jax_warp()
    jfn, tfn = (jwarp.invert, warp.invert) if inverse else (jwarp.augment, warp.augment)
    ref = _jax(jfn, images, degrees, hflip, fill, "shear")
    for method in ("shear", "cuda"):  # "cuda" on a CPU tensor = the kernel's plain version
        out = _port(tfn, images, degrees, hflip, fill, method)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= 1e-5, method


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [2, 3])
def test_plain_kernel_matches_pallas_interpret(c, inverse):
    images, degrees, hflip, fill = _inputs(c, "image", seed=10 + c)
    _jax_warp()
    import jax.numpy as jnp
    from aide_tpu.ops.pallas_warp import warp_rotate_flip as pallas_warp_rotate_flip

    ref = np.asarray(pallas_warp_rotate_flip(
        jnp.asarray(images), jnp.asarray(degrees), jnp.asarray(hflip), jnp.asarray(fill),
        inverse=inverse, interpret=True,
    ))
    out = cuda_warp.warp_rotate_flip(
        torch.from_numpy(images), torch.from_numpy(degrees), torch.from_numpy(hflip),
        torch.from_numpy(fill), inverse=inverse,
    ).numpy()
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size", [32, 64])
def test_port_warps_match_pallas_interpret_past_180(size, inverse):
    """The angles the kernel's staged path does not cover alone: the plain
    version and the port's shear path against the Pallas kernel in
    interpret mode, both flips, (B, C) fills."""
    rng = np.random.default_rng(size + inverse)
    degrees = np.concatenate([WIDE_DEGS, WIDE_DEGS])
    hflip = np.repeat(np.array([0.0, 1.0], np.float32), len(WIDE_DEGS))
    images = rng.normal(size=(len(degrees), size, size, 3)).astype(np.float32)
    fill = rng.normal(size=(len(degrees), 3)).astype(np.float32)
    _jax_warp()
    import jax.numpy as jnp
    from aide_tpu.ops.pallas_warp import warp_rotate_flip as pallas_warp_rotate_flip

    ref = np.asarray(pallas_warp_rotate_flip(
        jnp.asarray(images), jnp.asarray(degrees), jnp.asarray(hflip), jnp.asarray(fill),
        inverse=inverse, interpret=True,
    ))
    tfn = warp.invert if inverse else warp.augment
    for method in ("shear", "cuda"):  # "cuda" on a CPU tensor = the kernel's plain version
        out = _port(tfn, images, degrees, hflip, fill, method)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= 1e-5, method


@pytest.mark.parametrize("inverse", [False, True])
def test_gather_path_matches_jax(inverse):
    images, degrees, hflip, fill = _inputs(2, "image", seed=5)
    jwarp = _jax_warp()
    jfn, tfn = (jwarp.invert, warp.invert) if inverse else (jwarp.augment, warp.augment)
    ref = _jax(jfn, images, degrees, hflip, fill, "gather")
    out = _port(tfn, images, degrees, hflip, fill, "gather")
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("method", ["auto", "shear", "cuda"])
def test_non_square_routes_to_gather(method):
    rng = np.random.default_rng(3)
    images = rng.normal(size=(4, 24, 40, 2)).astype(np.float32)
    degrees = np.array([10.0, -50.0, 70.0, 0.0], np.float32)
    hflip = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    fill = rng.normal(size=(4, 2)).astype(np.float32)
    ref = _jax(_jax_warp().augment, images, degrees, hflip, fill, "gather")
    out = _port(warp.augment, images, degrees, hflip, fill, method)
    assert out.shape == (4, 24, 40, 2)
    assert np.abs(out - ref).max() <= 1e-5
    assert warp._resolve_method(method, torch.from_numpy(images)) == "gather"


def test_auto_resolves_to_shear_on_cpu_tensors():
    x = torch.zeros((1, 8, 8, 1))
    assert warp._resolve_method("auto", x) == "shear"
    assert warp._resolve_method("cuda", x) == "cuda"


@pytest.mark.parametrize("bad", ["gahter", "pallas", ""])
def test_unknown_method_raises(bad):
    x = torch.zeros((1, 8, 8, 1))
    with pytest.raises(ValueError):
        warp.augment(x, torch.zeros(1), torch.zeros(1), method=bad)


def test_kernel_wrapper_rejects_non_square():
    with pytest.raises(ValueError):
        cuda_warp.warp_rotate_flip(torch.zeros((1, 8, 9, 1)), torch.zeros(1), torch.zeros(1), 0.0)


def test_launch_counter_does_not_move_on_cpu_tensors():
    images, degrees, hflip, fill = _inputs(2, "image")
    before = trace.totals()
    for inverse in (False, True):
        cuda_warp.warp_rotate_flip(torch.from_numpy(images), torch.from_numpy(degrees),
                                   torch.from_numpy(hflip), torch.from_numpy(fill), inverse)
    assert "warp.launches" not in trace.delta(before)


def test_dtype_round_trip_computes_in_f32():
    images, degrees, hflip, fill = _inputs(3, "image", seed=8)
    x = torch.from_numpy(images)
    out16 = cuda_warp.warp_rotate_flip(x.to(torch.bfloat16), torch.from_numpy(degrees),
                                       torch.from_numpy(hflip), torch.from_numpy(fill))
    out32 = cuda_warp.warp_rotate_flip(x.to(torch.bfloat16).float(), torch.from_numpy(degrees),
                                       torch.from_numpy(hflip), torch.from_numpy(fill))
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))


def test_kernel_source_has_the_wrappers_geometry():
    with open(cuda_warp.SOURCE) as fh:
        src = fh.read()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == cuda_warp.TILE
    assert int(re.search(r"constexpr int kBoxSide = (\d+);", src).group(1)) == cuda_warp.BOX_SIDE
    assert "(kBoxSide * c) | 1" in src  # the pitch smem_bytes assumes


def test_launch_raises_when_the_box_exceeds_shared_memory():
    c = next(c for c in range(1, 64) if cuda_warp.smem_bytes(c) > cuda_warp.SMEM_LIMIT)
    assert cuda_warp.smem_bytes(c - 1) <= cuda_warp.SMEM_LIMIT
    x = torch.zeros((1, 8, 8, c))
    with pytest.raises(ValueError, match="shared memory"):
        cuda_warp.launch(x, torch.zeros((1, 4)), torch.zeros((1, c)), inverse=False)


@pytest.mark.parametrize("hflip", [0.0, 1.0])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size", [33, 100, 256])
def test_source_boxes_fit_box_side(size, inverse, hflip):
    degrees = torch.from_numpy(np.concatenate(
        [np.arange(-180.0, 180.01, 2.5, dtype=np.float32), BOUNDARY_DEGS]))
    worst = 0
    for chunk in torch.split(degrees, 16):
        table = cuda_warp.coef_table(chunk, torch.full_like(chunk, hflip), inverse)
        boxes = cuda_warp.source_boxes(table, size, inverse)
        t = -(-size // cuda_warp.TILE)
        assert boxes.shape == (len(chunk), t, t, 4)
        read = boxes[..., 0] <= boxes[..., 1]
        assert bool(read.any())
        h = (boxes[..., 1] - boxes[..., 0] + 1)[read]
        w = (boxes[..., 3] - boxes[..., 2] + 1)[read]
        assert int(boxes[..., 0][read].min()) >= 0 and int(boxes[..., 2][read].min()) >= 0
        assert int(boxes[..., 1][read].max()) < size and int(boxes[..., 3][read].max()) < size
        worst = max(worst, int(h.max()), int(w.max()))
    assert worst <= cuda_warp.BOX_SIDE
    if size >= 2 * cuda_warp.TILE:  # a whole tile at 45 degrees reads ~1.5x its side
        assert worst > 1.4 * cuda_warp.TILE


@pytest.mark.parametrize("hflip", [0.0, 1.0])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size", [64, 100])
def test_global_tiles_count_the_boxes_past_box_side(size, inverse, hflip):
    """Over -720..720 degrees: a tile whose box is at most BOX_SIDE on a
    side (or that reads no tap) takes the staged path, global_tiles counts
    the others, none of them within ±180 degrees and some past it."""
    degrees = torch.from_numpy(np.arange(-720.0, 720.01, 2.5, dtype=np.float32))
    total = 0
    for chunk in torch.split(degrees, 64):
        table = cuda_warp.coef_table(chunk, torch.full_like(chunk, hflip), inverse)
        boxes = cuda_warp.source_boxes(table, size, inverse)
        read = boxes[..., 0] <= boxes[..., 1]
        fits = ((boxes[..., 1] - boxes[..., 0] + 1 <= cuda_warp.BOX_SIDE)
                & (boxes[..., 3] - boxes[..., 2] + 1 <= cuda_warp.BOX_SIDE))
        staged = ~read | fits
        assert cuda_warp.global_tiles(boxes) == int((~staged).sum())
        assert bool(staged[chunk.abs() <= 180.0].all())
        total += int((~staged).sum())
    assert total > 0


@pytest.mark.parametrize("deg,n_global,side", [
    (217.25, 0, 50), (217.5, 4, 51), (250.0, 8, 51), (265.0, 24, 71), (269.5, 4, 243),
    (300.0, 0, 50), (360.0, 0, 34), (540.0, 0, 34),
])
def test_global_tiles_at_256px(deg, n_global, side):
    """The onset and the extremes at 256 px, ±deg in one launch of 2 x 64
    tiles: the first box over BOX_SIDE at 217.5 degrees, the whole image
    near 270, every box within BOX_SIDE again from 300."""
    degrees = torch.tensor([deg, -deg])
    table = cuda_warp.coef_table(degrees, torch.zeros(2), False)
    boxes = cuda_warp.source_boxes(table, 256, False)
    read = boxes[..., 0] <= boxes[..., 1]
    sides = torch.maximum(boxes[..., 1] - boxes[..., 0], boxes[..., 3] - boxes[..., 2]) + 1
    assert cuda_warp.global_tiles(boxes) == n_global
    assert int(sides[read].max()) == side


@pytest.mark.parametrize("inverse", [False, True])
def test_source_boxes_hold_every_read_tap(inverse):
    # the plain version over a source that is NaN outside one tile's box:
    # that tile's outputs stay finite only if every tap it reads is inside
    size, tile = 70, cuda_warp.TILE
    degrees = torch.tensor([0.0, 30.0, -45.0, 45.1, 100.0, -135.0, 180.0])
    hflip = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    table = cuda_warp.coef_table(degrees, hflip, inverse)
    n = len(degrees)
    fill = torch.zeros((n, 1))
    boxes = cuda_warp.source_boxes(table, size, inverse)
    t = boxes.shape[1]
    for i in range(t):
        for j in range(t):
            images = torch.full((n, size, size, 1), float("nan"))
            for k in range(n):
                r0, r1, c0, c1 = boxes[k, i, j].tolist()
                if r0 <= r1:
                    images[k, r0:r1 + 1, c0:c1 + 1] = 1.0
            out = cuda_warp.warp_plain(images, table, fill, inverse)
            tile_out = out[:, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            assert bool(torch.isfinite(tile_out).all()), (i, j)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_matches_plain(device, images, degrees, hflip, fill, inverse):
    x = torch.from_numpy(images).to(device)
    d = torch.from_numpy(degrees).to(device)
    h = torch.from_numpy(hflip).to(device)
    f = torch.from_numpy(fill).to(device)
    before = launches()
    got = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse)
    assert launches() == before + 1
    table = cuda_warp.coef_table(d, h, inverse)
    ref = cuda_warp.warp_plain(x, table, cuda_warp.fill_table(f, x.shape[0], x.shape[3], device),
                               inverse)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size,c", [(33, 3), (64, 2), (100, 2), (256, 3), (512, 2), (64, 1), (100, 5)])
def test_cuda_kernel_matches_plain(cuda_device, size, c, inverse):
    images, degrees, hflip, fill = _inputs(c, "image", size=size, seed=size + c)
    # up to ±135 degrees, then the regime boundaries with both flips
    degrees = np.concatenate([degrees * 1.5, BOUNDARY_DEGS, BOUNDARY_DEGS])
    hflip = np.concatenate([hflip, np.zeros(len(BOUNDARY_DEGS)), np.ones(len(BOUNDARY_DEGS))])
    rng = np.random.default_rng(size)
    images = np.concatenate([images, rng.normal(size=(2 * len(BOUNDARY_DEGS),) + images.shape[1:])])
    fill = np.concatenate([fill, rng.normal(size=(2 * len(BOUNDARY_DEGS), c))])
    _cuda_matches_plain(cuda_device, images.astype(np.float32), degrees.astype(np.float32),
                        hflip.astype(np.float32), fill.astype(np.float32), inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size,c", [(33, 3), (64, 2), (100, 3), (256, 2), (512, 3)])
def test_cuda_kernel_past_180(cuda_device, size, c, inverse):
    """Both paths of the kernel: exact against the plain version at the
    angles past ±180 degrees, both flips, one launch; at 64 px and up some
    tiles take the global-tap path."""
    rng = np.random.default_rng(size + c)
    degrees = np.concatenate([WIDE_DEGS, WIDE_DEGS])
    hflip = np.repeat(np.array([0.0, 1.0], np.float32), len(WIDE_DEGS))
    x = torch.from_numpy(rng.normal(size=(len(degrees), size, size, c)).astype(np.float32))
    f = torch.from_numpy(rng.normal(size=(len(degrees), c)).astype(np.float32))
    x, f = x.to(cuda_device), f.to(cuda_device)
    d, h = torch.from_numpy(degrees).to(cuda_device), torch.from_numpy(hflip).to(cuda_device)
    before = launches()
    got = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse)
    assert launches() == before + 1
    table = cuda_warp.coef_table(d, h, inverse)
    ref = cuda_warp.warp_plain(x, table, cuda_warp.fill_table(f, len(x), c, cuda_device), inverse)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    n_global = cuda_warp.global_tiles(cuda_warp.source_boxes(table, size, inverse))
    assert (n_global > 0) == (size >= 64)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size,c,deg,flip", [(33, 2, -60.0, 0.0), (256, 3, 45.0, 1.0)])
def test_cuda_kernel_single_image(cuda_device, size, c, deg, flip, inverse):
    rng = np.random.default_rng(size + c)
    images = rng.normal(size=(1, size, size, c)).astype(np.float32)
    fill = rng.normal(size=(1, c)).astype(np.float32)
    _cuda_matches_plain(cuda_device, images, np.array([deg], np.float32),
                        np.array([flip], np.float32), fill, inverse)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size,rows", [(256, (0, 128)), (256, (128, 128)), (256, (64, 64)),
                                       (100, (37, 50)), (33, (0, 33))])
def test_cuda_kernel_row_window(cuda_device, size, rows, inverse):
    """A launch of output rows [row0, row0 + R) equals the plain version's
    window and the whole launch's rows exactly, at angles over ±135 and
    both flips; one launch a call."""
    images, degrees, hflip, fill = _inputs(3, "image", size=size, seed=size + rows[0])
    degrees = np.concatenate([degrees * 1.5, BOUNDARY_DEGS]).astype(np.float32)
    hflip = np.concatenate([hflip, np.ones(len(BOUNDARY_DEGS))]).astype(np.float32)
    rng = np.random.default_rng(size)
    images = np.concatenate([images, rng.normal(size=(len(BOUNDARY_DEGS),) + images.shape[1:])])
    fill = np.concatenate([fill, rng.normal(size=(len(BOUNDARY_DEGS), 3))])
    x = torch.from_numpy(images.astype(np.float32)).to(cuda_device)
    d, h = torch.from_numpy(degrees).to(cuda_device), torch.from_numpy(hflip).to(cuda_device)
    f = torch.from_numpy(fill.astype(np.float32)).to(cuda_device)
    before = launches()
    got = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse, rows=rows)
    assert launches() == before + 1 and tuple(got.shape) == (len(x), rows[1], size, 3)
    whole = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse)
    table = cuda_warp.coef_table(d, h, inverse)
    ref = cuda_warp.warp_plain(x, table, cuda_warp.fill_table(f, len(x), 3, cuda_device), inverse,
                               rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, whole[:, rows[0]:rows[0] + rows[1]])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,inverse", [((16, 256, 256, 3), False), ((32, 256, 256, 2), True)])
def test_cuda_kernel_at_the_real_programs_shapes(cuda_device, shape, inverse):
    """The AIDE rungs of the real-data CHAOS programs (two-modal FuseUNet,
    256 px, batch 4, 4 views at +-60 degrees): both modalities' views, then
    both nets' logits, against the plain version."""
    rng = np.random.default_rng(shape[0] + shape[3])
    _cuda_matches_plain(cuda_device, rng.normal(size=shape).astype(np.float32),
                        rng.uniform(-60, 60, shape[0]).astype(np.float32),
                        (rng.random(shape[0]) < 0.5).astype(np.float32),
                        rng.normal(size=(shape[0], shape[3])).astype(np.float32), inverse)
