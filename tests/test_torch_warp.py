"""The port's warps against the JAX package's (max abs <= 1e-5, the bar of
tests/test_pallas_warp.py).

The port's shear path and the CUDA kernel's plain version (what the kernel
wrapper runs for a CPU tensor) against the JAX shear path over degrees
{0, ±23, ±45, ±52, ±60, 90} with flips on and off, scalar / (C,) / (B, C)
fills and C in {1, 2, 3}, in both directions; the plain version also
against the Pallas kernel itself in interpret mode. A cuda-marked case holds
the CUDA kernel to its plain version on a card.

The JAX package is imported inside the tests that use it, so the file also
runs where only PyTorch is installed: there the cuda-marked cases run and
the JAX comparisons skip (python -m pytest tests/test_torch_warp.py -m cuda).
"""

import numpy as np
import pytest
import torch

from aide_tpu_torch.ops import cuda_warp, warp

DEGS = np.array([0.0, 23.0, -23.0, 45.0, -45.0, 52.0, -52.0, 60.0, -60.0, 90.0], np.float32)


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
    cuda_warp.reset_launches()
    for inverse in (False, True):
        cuda_warp.warp_rotate_flip(torch.from_numpy(images), torch.from_numpy(degrees),
                                   torch.from_numpy(hflip), torch.from_numpy(fill), inverse)
    assert cuda_warp.launches == 0


def test_dtype_round_trip_computes_in_f32():
    images, degrees, hflip, fill = _inputs(3, "image", seed=8)
    x = torch.from_numpy(images)
    out16 = cuda_warp.warp_rotate_flip(x.to(torch.bfloat16), torch.from_numpy(degrees),
                                       torch.from_numpy(hflip), torch.from_numpy(fill))
    out32 = cuda_warp.warp_rotate_flip(x.to(torch.bfloat16).float(), torch.from_numpy(degrees),
                                       torch.from_numpy(hflip), torch.from_numpy(fill))
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.to(torch.bfloat16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("size,c", [(64, 2), (256, 3), (512, 2)])
def test_cuda_kernel_matches_plain(cuda_device, size, c, inverse):
    images, degrees, hflip, fill = _inputs(c, "image", size=size, seed=size + c)
    x = torch.from_numpy(images).to(cuda_device)
    d = torch.from_numpy(degrees).to(cuda_device) * 1.5  # up to ±135 degrees
    h = torch.from_numpy(hflip).to(cuda_device)
    f = torch.from_numpy(fill).to(cuda_device)
    before = cuda_warp.launches
    got = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse)
    assert cuda_warp.launches == before + 1
    table = cuda_warp.coef_table(d, h, inverse)
    ref = cuda_warp.warp_plain(x, table, cuda_warp.fill_table(f, x.shape[0], c, cuda_device), inverse)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
