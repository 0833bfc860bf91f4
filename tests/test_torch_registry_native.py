"""The port's registries, checkpoint_flush and native host library against
the JAX package's.

- ``aide_tpu_torch.core`` exports ``MODELS``, ``TASKS`` and ``LOSSES``
  with the JAX package's names and error texts; ``build_model`` and
  ``build_task`` are lookups in them; a network registered under a new
  name builds, trains one co-teaching epoch through ``Trainer`` on the CPU
  (its best exports and ``_full`` files written) and resumes from its
  ``_last_full`` file; ``space_needs`` refuses to size it.
- ``checkpoint_flush``: any value but "best" writes what "end" writes, as
  the JAX trainer reads the key (``aide_tpu/engine/trainer.py:824``), at
  the JAX package's own small sizes (``tests/test_trainer.py::small_cfg``).
- The native host library (``csrc/hostops.cpp`` through
  ``aide_tpu_torch.native``): ``keep_largest_cc`` equals the plain twin and
  the JAX package's ``aide_tpu.native.keep_largest_cc`` on seeded 2-D and
  3-D masks, exact ties of the largest size and an empty mask;
  ``volume_confusion`` equals numpy's counts; a missing compiler raises
  rather than falling back.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy import ndimage
from torch import nn

from aide_tpu.core import registry as jregistry
from aide_tpu import native as jnative

from aide_tpu_torch import native
from aide_tpu_torch.core import LOSSES, MODELS, TASKS
from aide_tpu_torch.core.config import ModelConfig, TrainConfig
from aide_tpu_torch.core.registry import Registry
from aide_tpu_torch.data.tasks import build_task
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine.trainer import Trainer
from aide_tpu_torch.models import FuseUNet, UNet, build_model, space_needs
from aide_tpu_torch.ops.cc import (
    keep_largest_connected_components,
    keep_largest_connected_components_plain,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------- registries -------------------------------


def test_registry_names_equal_jax():
    import aide_tpu.data  # noqa: F401  (imports the task modules, which register)
    import aide_tpu.models  # noqa: F401

    assert MODELS.names() == jregistry.MODELS.names()
    assert TASKS.names() == jregistry.TASKS.names()
    assert LOSSES.names() == jregistry.LOSSES.names() == []
    assert "fuseunet" in MODELS and "kidney" in TASKS and "x" not in MODELS


def test_registry_error_texts_equal_jax():
    errors = []
    for cls in (Registry, jregistry.Registry):
        reg = cls("model")
        reg.register("b")(len)
        reg.register("a")(len)
        with pytest.raises(KeyError) as dup:
            reg.register("a")(len)
        with pytest.raises(KeyError) as unknown:
            reg.get("c")
        errors.append((str(dup.value), str(unknown.value), reg.names()))
    assert errors[0] == errors[1]
    assert errors[0][2] == ["a", "b"]


@pytest.mark.parametrize("name", ["unet", "unetsa", "unet4", "fuseunet", "fuseunetsaseparate"])
def test_build_model_is_the_registry_lookup(name):
    cfg = ModelConfig(name=name, base_width=2, compute_dtype="float32")
    net = build_model(cfg)
    assert type(net) is type(MODELS.get(name)(cfg))
    assert isinstance(net, FuseUNet if name.startswith("fuseunet") else UNet)
    assert net.arch["model_name"] == name.rstrip("0123456789")
    default = build_model(ModelConfig(name=name, compute_dtype="float32"))
    width = {"unet4": 4}.get(name, 32 if name.startswith("fuseunet") else 64)
    assert net.last_conv1.in_channels * width == default.last_conv1.in_channels * 2


def test_build_model_refuses_an_unknown_name():
    with pytest.raises(KeyError, match=r"unknown model 'unet3'; available: \['fuseunet'"):
        build_model(ModelConfig(name="unet3"))


class TinyNet(nn.Module):
    """A network outside the zoo: (B, H, W, 3) -> (B, H, W, C) logits, the
    forward the trainer calls (``update_stats`` only matters to BatchNorm,
    which it has none of)."""

    def __init__(self, num_classes: int, width: int):
        super().__init__()
        self.conv = nn.Conv2d(3, width, 3, padding=1)
        self.head = nn.Conv2d(width, num_classes, 1)

    def forward(self, image, update_stats: bool = True):
        x = torch.relu(self.conv(image.permute(0, 3, 1, 2)))
        return self.head(x).permute(0, 2, 3, 1).float()


@pytest.fixture
def tinynet(monkeypatch):
    monkeypatch.setitem(MODELS._items, "tinynet", lambda cfg: TinyNet(cfg.num_classes, 4))
    return "tinynet"


def _small_cfg(tmp_path, name="unet4", **kw):
    """tests/test_trainer.py::small_cfg in the port's config."""
    cfg = TrainConfig()
    cfg.model = ModelConfig(name=name, compute_dtype="float32", norm="group")
    cfg.data.task = "synthetic"
    cfg.data.variant = "proposed"
    cfg.data.img_size = 32
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 4
    cfg.data.num_tta_views = 2
    cfg.data.rotation_degree = 20.0
    cfg.coteach.warmup_epochs = 2
    cfg.coteach.consistency_weight = 1.0
    cfg.num_epochs = 2
    cfg.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.history_dir = str(tmp_path / "hist")
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _small_task(tmp_path):
    """tests/test_trainer.py::make_trainer's task."""
    return SyntheticTask(root=str(tmp_path / "synth"), tempmask_folder="tempmasks", num_cases=4,
                         slices_per_case=4, size=32, noisy_fraction=0.5, seed=3)


def test_a_registered_model_trains_and_resumes(tmp_path, tinynet):
    cfg = _small_cfg(tmp_path, tinynet)
    tr = Trainer(cfg, _small_task(tmp_path), device="cpu")
    assert all(isinstance(net, TinyNet) for net in tr.state.nets)
    rows = tr.run(1)
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    assert tr.refresh_log  # the warmup refreshed a case of each net
    names = set(os.listdir(cfg.checkpoint_dir))
    prefix = cfg.experiment_name
    assert {f"{prefix}_net1_besttraincasedice.pkl", f"{prefix}_net2_besttraincasedice.pkl",
            f"{prefix}_full.msgpack", f"{prefix}_last_full.msgpack"} <= names
    export = torch.load(os.path.join(cfg.checkpoint_dir, f"{prefix}_net1_besttraincasedice.pkl"),
                        weights_only=True)
    assert set(export["net"]) == set(tr.state.nets[0].state_dict())

    cfg.resume_file = ckpt.full_path(cfg.checkpoint_dir, prefix, last=True)
    again = Trainer(cfg, _small_task(tmp_path), device="cpu")
    assert again.start_epoch == 1 and again.history == tr.history
    for a, b in zip(again.state.nets, tr.state.nets):
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    assert again.state.optimizer.count == tr.state.optimizer.count


def test_space_needs_refuses_a_registered_model(tinynet):
    with pytest.raises(KeyError, match="cannot size a space axis for model 'tinynet'"):
        space_needs(ModelConfig(name=tinynet))
    assert space_needs(ModelConfig(name="unetsa", attention_dilation=4)) == (4, 4)


def test_build_task_looks_up_a_registered_task(tmp_path, monkeypatch):
    class MyTask(SyntheticTask):
        name = "mytask"

        def __init__(self, root, tempmask_folder, mask_identity, **kw):
            super().__init__(root=root, tempmask_folder=tempmask_folder, **kw)
            self.mask_identity = mask_identity

    monkeypatch.setitem(TASKS._items, "mytask", MyTask)
    cfg = _small_cfg(tmp_path)
    cfg.data.task, cfg.data.root = "mytask", str(tmp_path / "mine")
    cfg.data.task_options = {"num_cases": 2, "slices_per_case": 2, "size": 32}
    task = build_task(cfg)
    assert type(task) is MyTask and task.root == cfg.data.root
    cfg.data.task = "nosuchtask"
    with pytest.raises(KeyError, match="unknown task 'nosuchtask'; available: "):
        build_task(cfg)


# ------------------------------- checkpoint_flush -------------------------------


def _checkpoint_files(cfg) -> dict:
    """Every file the run wrote under checkpoint_dir: the exports' state
    dicts, the msgpack files' bytes, the sidecars' JSON."""
    out = {}
    for name in sorted(os.listdir(cfg.checkpoint_dir)):
        path = os.path.join(cfg.checkpoint_dir, name)
        if name.endswith(".pkl"):
            obj = torch.load(path, weights_only=True)
            out[name] = ({k: v.numpy().tobytes() for k, v in obj.pop("net").items()}, obj)
        elif name.endswith(".json"):
            with open(path) as fh:
                out[name] = json.load(fh)
        else:
            with open(path, "rb") as fh:
                out[name] = fh.read()
    return out


def test_any_checkpoint_flush_but_best_writes_what_end_writes(tmp_path):
    files = {}
    for mode in ("end", "never", "best"):
        cfg = _small_cfg(tmp_path / mode, checkpoint_flush=mode)
        tr = Trainer(cfg, _small_task(tmp_path / mode), device="cpu")
        tr.run_epoch(0)  # epoch 0 is always a best epoch
        best = os.path.join(cfg.checkpoint_dir, f"{cfg.experiment_name}_full.msgpack")
        assert os.path.exists(best) == (mode == "best"), mode  # the others defer
        tr.flush_checkpoints()
        files[mode] = _checkpoint_files(cfg)
    assert files["never"] == files["end"] == files["best"]
    assert len(files["end"]) == 6  # two exports and the _full file, each with its sidecar


# ------------------------------- native host library -------------------------------


def _tied(rng, shape, n, size):
    """``n`` disjoint components of exactly ``size`` voxels each (straight
    runs along the last axis, on rows whose other indices are all even, so
    no two touch) in random places, and ``n`` smaller ones."""
    m = np.zeros(shape, np.uint8)
    rows = [idx for idx in np.ndindex(*shape[:-1]) if not any(i % 2 for i in idx)]
    for k, i in enumerate(rng.permutation(len(rows))[: 2 * n]):
        length = size if k < n else int(rng.integers(1, size))
        start = int(rng.integers(0, shape[-1] - length + 1))
        m[rows[i] + (slice(start, start + length),)] = 1
    return m


def _masks():
    rng = np.random.default_rng(2024)
    masks = {"empty_2d": np.zeros((7, 9), np.uint8), "empty_3d": np.zeros((3, 7, 9), np.uint8)}
    for seed in range(4):
        r = np.random.default_rng(seed)
        masks[f"random_2d_{seed}"] = (r.random((40, 48)) < 0.45 + 0.05 * seed).astype(np.uint8)
        masks[f"random_3d_{seed}"] = (r.random((6, 24, 20)) < 0.3 + 0.05 * seed).astype(np.uint8)
        masks[f"tied_2d_{seed}"] = _tied(rng, (16, 20), 2 + seed % 3, 6)
        masks[f"tied_3d_{seed}"] = _tied(rng, (4, 10, 12), 2 + seed % 3, 5)
    masks["bool_3d"] = np.random.default_rng(9).random((5, 16, 16)) < 0.5
    return masks


@pytest.mark.parametrize("name", sorted(_masks()))
def test_native_cc_equals_the_plain_twin_and_jax(name):
    mask = _masks()[name]
    got = keep_largest_connected_components(mask)
    assert got.dtype == np.uint8 and got.shape == mask.shape
    assert np.array_equal(got, native.keep_largest_cc(mask))
    assert np.array_equal(got, keep_largest_connected_components_plain(mask))
    want = jnative.keep_largest_cc(mask)
    if want is None:
        pytest.skip("the JAX package's native library cannot be built here")
    assert np.array_equal(got, want)
    if name.startswith("tied"):
        sizes = np.bincount(ndimage.label(mask)[0].ravel())
        assert (sizes[1:] == sizes[1:].max()).sum() >= 2  # a real tie of the largest size
        assert got.sum() == sizes[1:].max()


def test_native_cc_refuses_other_ranks():
    with pytest.raises(ValueError, match=r"\(H, W\) or \(S, H, W\)"):
        native.keep_largest_cc(np.ones((2, 2, 2, 2), np.uint8))


@pytest.mark.parametrize("shape", [(5, 33, 31), (64, 64)])
def test_native_volume_confusion_equals_numpy(shape):
    rng = np.random.default_rng(len(shape))
    pred = (rng.random(shape) < 0.4).astype(np.uint8)
    target = rng.random(shape) < 0.5
    p, t = pred > 0, target
    assert native.volume_confusion(pred, target) == (
        int((p & t).sum()), int((~p & ~t).sum()), int((p & ~t).sum()), int((~p & t).sum()))
    with pytest.raises(ValueError, match="shape mismatch"):
        native.volume_confusion(pred, target[..., :-1])


def test_native_library_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "host"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-g.. not found"):
        keep_largest_connected_components(np.ones((4, 4), np.uint8))
    assert not os.path.exists(tmp_path / "host")


def test_native_library_builds_once_per_source(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "host"))
    path = native.build()
    assert os.path.dirname(path) == str(tmp_path / "host")
    assert native.build() == path and os.listdir(tmp_path / "host") == [os.path.basename(path)]
    src = tmp_path / "hostops.cpp"
    with open(native.SOURCE) as fh:
        src.write_text(fh.read() + "\n// another source\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    assert native.build() != path
