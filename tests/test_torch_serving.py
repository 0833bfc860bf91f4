"""The port's serving artifacts (``aide_tpu_torch.interop.serving``) against aide_tpu's.

On the CPU, 16 px, f32 compute unless said otherwise. The weights are the
JAX package's initialisation with the BatchNorm statistics moved off their
initial values, carried into the port through ``interop.weights``; the
inputs come from ``np.random.default_rng``. One export per (model, weights
dtype) in each package, shared by the module:
- the port's artifact round trip at batch 1 and 3 (symbolic batch),
  single-modal GroupNorm ``unet2`` and two-modal BatchNorm ``fuseunet``:
  the port's eager net plus softmax within 1e-5 (``tests/test_interop.py``'s
  bar), the header's keys;
- against ``aide_tpu.interop.serving``'s artifact of the same weights
  within 1e-4 (``test_torch_model.py``'s bar at f32), float32 and bfloat16
  weights (BatchNorm at bf16: ``test_matches_jax_artifact``);
- bfloat16 weights: under 0.75x the float32 artifact, equal within 1e-5 to
  the eager net whose every floating leaf (BatchNorm statistics included)
  was rounded to bf16, mean |delta| from float32 under 5e-3, sums 1 within
  1e-5; ``ValueError`` on another dtype;
- a subprocess without the repo on ``sys.path`` reads the container with
  the standard library and ``torch.export.load``, gives the same
  probabilities and finds every stored floating leaf in bf16;
- the refusals: a JAX artifact given to the port's loader, a port artifact
  to the JAX package's, a foreign file, a platform the artifact lacks;
- a model with ``remat`` and the learned upsample, in bf16 compute, exports
  and serves like the plain ones, its convolutions in bf16;
- ``build_model`` with ``param_dtype="bfloat16"`` builds the float32
  parameters the JAX package builds for it.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aide_tpu.core.config import ModelConfig as JModelConfig
from aide_tpu.interop import serving as jserving
from aide_tpu.models import build_model as j_build_model

from aide_tpu_torch.core.config import ModelConfig
from aide_tpu_torch.interop import serving, weights
from aide_tpu_torch.models import build_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SIZE = 16
MODELS = {
    "unet2_group": dict(name="unet2", norm="group"),
    "fuseunet_batch": dict(name="fuseunet", base_width=2, norm="batch"),
}
DTYPES = ("float32", "bfloat16")


def _nets(options, seed, compute_dtype="float32"):
    """(JAX model, its variables, the port's net with them in eval mode,
    two_modal) of ModelConfig ``options``; BatchNorm statistics moved."""
    jm = j_build_model(JModelConfig(compute_dtype=compute_dtype, **options))
    two_modal = options["name"].startswith("fuseunet")
    z = jnp.zeros((1, SIZE, SIZE, 3))
    v = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(seed), *(z,) * (1 + two_modal), train=False))
    rng = np.random.default_rng(seed)
    for path, arr in jax.tree_util.tree_leaves_with_path(v.get("batch_stats", {})):
        if str(path[-1]) == "['mean']":
            arr += rng.normal(0.0, 0.1, arr.shape).astype(np.float32)
        else:
            arr *= rng.uniform(0.8, 1.2, arr.shape).astype(np.float32)
    net = build_model(ModelConfig(compute_dtype=compute_dtype, **options))
    weights.load_variables(net, v)
    return jm, v, net.eval(), two_modal


def _images(two_modal, b, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
            for _ in range(1 + two_modal)]


def _eager(net, images):
    with torch.no_grad():
        return torch.softmax(net(*map(torch.from_numpy, images)).float(), -1).numpy()


def _rounded(tree):
    """Every floating leaf of ``tree`` rounded to bf16 and widened back."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        if np.issubdtype(a.dtype, np.floating) else a, tree)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{(model, weights dtype): the port's and the JAX package's artifacts of
    the same weights, loaded; for bf16 also the JAX package's float32
    artifact of the bf16-rounded weights}."""
    tmp = tmp_path_factory.mktemp("serve")
    out = {}
    for seed, (model, options) in enumerate(MODELS.items()):
        jm, v, net, two_modal = _nets(options, seed)
        for dtype in DTYPES:
            path, jpath = str(tmp / f"{model}_{dtype}.serve"), str(tmp / f"{model}_{dtype}.jax")
            serving.export_serving_artifact(path, net, SIZE, two_modal, meta={"model": model},
                                            weights_dtype=dtype, platforms=("cpu",))
            jserving.export_serving_artifact(jpath, jm, v, SIZE, two_modal, weights_dtype=dtype)
            call, header = serving.load_serving_artifact(path, "cpu")
            out[model, dtype] = dict(path=path, jpath=jpath, call=call, header=header,
                                     jcall=jserving.load_serving_artifact(jpath)[0], net=net,
                                     two_modal=two_modal)
        rpath = str(tmp / f"{model}_rounded.jax")
        jserving.export_serving_artifact(rpath, jm, _rounded(v), SIZE, two_modal)
        out[model, "bfloat16"]["jcall_rounded"] = jserving.load_serving_artifact(rpath)[0]
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_round_trip_matches_eager(artifacts, model):
    a = artifacts[model, "float32"]
    for b in (1, 3):  # the symbolic batch dimension
        images = _images(a["two_modal"], b, seed=b)
        got = a["call"](*images)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert got.shape == (b, SIZE, SIZE, 2)
        np.testing.assert_allclose(got.numpy(), _eager(a["net"], images), rtol=0, atol=1e-5)
    h = a["header"]
    assert h["model"] == model and h["img_size"] == SIZE and h["two_modal"] is a["two_modal"]
    assert (h["input_dtype"], h["weights_dtype"], h["platforms"]) == ("float32", "float32", ["cpu"])
    assert h["torch_version"] == torch.__version__ and set(h["payloads"]) == {"cpu"}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", list(MODELS))
def test_matches_jax_artifact(artifacts, model, dtype):
    """float32 weights: the JAX package's artifact within 1e-4. bf16
    weights: its float32 artifact of the bf16-rounded weights (the function
    its serving docstring names) within 1e-4, and its bf16 artifact: within
    1e-4 for GroupNorm; for BatchNorm, flax's ``_normalize`` computes
    ``rsqrt(var + eps) * scale`` in bf16 from the bf16 statistics, where the
    port's program widens every leaf first, so within the bf16 bar of mean
    |delta| 5e-3 (ROADMAP.md, Queue 3)."""
    a = artifacts[model, dtype]
    images = _images(a["two_modal"], 3, seed=7)
    got = a["call"](*images).numpy()
    want = np.asarray(a["jcall"](*images))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    np.testing.assert_allclose(got, np.asarray(a["jcall_rounded"](*images)), rtol=1e-4, atol=1e-4)
    if MODELS[model]["norm"] == "group":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("model", list(MODELS))
def test_bf16_weights(artifacts, model):
    a32, a16 = artifacts[model, "float32"], artifacts[model, "bfloat16"]
    assert os.path.getsize(a16["path"]) < 0.75 * os.path.getsize(a32["path"])
    assert a16["header"]["weights_dtype"] == "bfloat16"
    images = _images(a16["two_modal"], 3, seed=11)
    got = a16["call"](*images).numpy()
    rounded = build_model(ModelConfig(compute_dtype="float32", **MODELS[model])).eval()
    rounded.load_state_dict({k: t.to(torch.bfloat16).float()
                             for k, t in a16["net"].state_dict().items()})
    np.testing.assert_allclose(got, _eager(rounded, images), rtol=0, atol=1e-5)
    assert float(np.abs(got - a32["call"](*images).numpy()).mean()) < 5e-3
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_export_refuses_other_dtypes_and_platforms(artifacts, tmp_path):
    net = artifacts["unet2_group", "float32"]["net"]
    with pytest.raises(ValueError, match="weights_dtype"):
        serving.export_serving_artifact(str(tmp_path / "x"), net, SIZE, False,
                                        weights_dtype="float16")
    for platforms in ((), ("tpu",), ("cpu", "cpu")):
        with pytest.raises(ValueError, match="platforms"):
            serving.export_serving_artifact(str(tmp_path / "x"), net, SIZE, False,
                                            platforms=platforms)
    assert not os.listdir(tmp_path)


READER = """
import importlib.util, io, json, sys
import numpy as np
import torch

assert importlib.util.find_spec("aide_tpu_torch") is None, "the port is importable"
torch.set_num_threads(1)
path, out = sys.argv[1], sys.argv[2]
with open(path, "rb") as fh:
    blob = fh.read()
assert blob[:8] == b"AIDETRC1"
n = int.from_bytes(blob[8:16], "little")
header = json.loads(blob[16:16 + n])
start, size = header["payloads"]["cpu"]
begin = 16 + n + start
program = torch.export.load(io.BytesIO(blob[begin:begin + size])).module()
images = [torch.from_numpy(np.load(f)) for f in sys.argv[3:]]
with torch.no_grad():
    np.save(out, program(*images).numpy())
stored = program.state_dict()
print(json.dumps({"header": header, "leaves": len(stored),
                  "stored": sorted({str(t.dtype) for t in stored.values()})}))
"""


def test_reader_without_the_port(artifacts, tmp_path):
    a = artifacts["fuseunet_batch", "bfloat16"]
    images = _images(True, 2, seed=5)
    files = []
    for i, x in enumerate(images):
        files.append(str(tmp_path / f"x{i}.npy"))
        np.save(files[-1], x)
    out = str(tmp_path / "probs.npy")
    proc = subprocess.run([sys.executable, "-I", "-c", READER, a["path"], out, *files],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every floating leaf is stored in bf16, the BatchNorm statistics included
    assert json.loads(proc.stdout.splitlines()[-1]) == dict(
        header=a["header"], leaves=len(a["net"].state_dict()), stored=["torch.bfloat16"])
    np.testing.assert_allclose(np.load(out), a["call"](*images).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["jax_to_port", "port_to_jax", "foreign", "absent_platform"])
def test_loaders_refuse(artifacts, tmp_path, case):
    a = artifacts["unet2_group", "float32"]
    if case == "jax_to_port":
        with pytest.raises(ValueError, match="StableHLO serving artifact of the JAX package"):
            serving.load_serving_artifact(a["jpath"], "cpu")
    elif case == "port_to_jax":
        with pytest.raises(ValueError, match="not an aide_tpu serving artifact"):
            jserving.load_serving_artifact(a["path"])
    elif case == "foreign":
        (tmp_path / "bogus.serve").write_bytes(b"not an artifact")
        with pytest.raises(ValueError, match="not an aide_tpu_torch serving artifact"):
            serving.load_serving_artifact(str(tmp_path / "bogus.serve"), "cpu")
    else:
        # no CPU program is ever moved onto the card
        with pytest.raises(ValueError, match=r"no program for 'cuda'.*\['cpu'\]"):
            serving.load_serving_artifact(a["path"], "cuda")


class _ConvDtypes(TorchDispatchMode):
    """Records the input dtype of every convolution that runs under it."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.dtypes.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


def test_remat_and_learned_upsample_serve(tmp_path):
    """A BatchNorm UNet with remat and the learned upsample, in bf16
    compute: the loaded program equals the eager net at batch 1 and 3 and
    runs every convolution in bf16."""
    options = dict(name="unet2", norm="batch", remat=True, learned_bilinear=True)
    _, _, net, _ = _nets(options, seed=3, compute_dtype="bfloat16")
    path = str(tmp_path / "net.serve")
    serving.export_serving_artifact(path, net, SIZE, False, platforms=("cpu",))
    call, _ = serving.load_serving_artifact(path, "cpu")
    for b in (1, 3):
        images = _images(False, b, seed=b)
        convs = _ConvDtypes()
        with convs:
            got = call(*images)
        np.testing.assert_allclose(got.numpy(), _eager(net, images), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
        assert convs.dtypes and set(convs.dtypes) == {torch.bfloat16}, convs.dtypes


def test_param_dtype_is_accepted_and_ignored_as_in_jax():
    options = dict(name="unet2", compute_dtype="float32", param_dtype="bfloat16")
    jm = j_build_model(JModelConfig(**options))
    x = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    assert {leaf.dtype for leaf in jax.tree_util.tree_leaves(v)} == {np.dtype(np.float32)}
    net = build_model(ModelConfig(**options)).eval()
    assert {t.dtype for t in net.state_dict().values()} == {torch.float32}
    weights.load_variables(net, v)
    want = np.asarray(jm.apply(v, x, train=False))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
