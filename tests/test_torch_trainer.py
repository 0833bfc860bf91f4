"""The slice as a whole: the port's Trainer against the JAX package's.

A tiny two-modal synthetic task (2 train cases x 4 slices, 32 px, batch 4,
2 TTA views, FuseUNet base width 4, f32). Both trainers start from the same
weights, and the port draws the JAX trainer's per-step view parameters
through its ``view_params`` seam; one ``_train_epoch(0, 0.5)`` and one
``_test_epoch()`` then give per-epoch metrics that agree to rtol 1e-3.

The learning rate is 1e-6. AMSGrad's first updates move each parameter by
about lr along its gradient's sign, and where f32 rounding does not fix
that sign the two packages move it 2*lr apart (test_torch_step holds one
step at lr 1e-4 for that). After two such steps at lr 1e-4 the thresholded
test dice differs between the packages, and between two thread counts of
the port alone, by up to ~6e-3; at 1e-6 both stay near 1e-6, so the
comparison at rtol 1e-3 tests the slice's data, view, step and metric
plumbing with margin.

Also: the port's SlicePipeline equals the JAX one bit for bit, the
same-size resize needs no Pillow, ``Trainer`` without a device raises where
there is no CUDA, and the port imports nothing of JAX or the JAX package.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.pipeline import SlicePipeline as JSlicePipeline
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import tta as jtta

import aide_tpu_torch
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks import base as tbase
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.interop.weights import load_variables


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
TASK_ARGS = dict(
    two_modal=True, num_cases=2, slices_per_case=4, size=32,
    noisy_fraction=0.5, clean_cases=1, seed=3,
)


def _cfgs(tmp_path):
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3  # ragged last test batch, no drop_last
    jcfg.data.num_tta_views = 2
    jcfg.optim.lr = 1e-6
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir = str(tmp_path / "ckpt")
    jcfg.history_dir = str(tmp_path / "hist")
    return jcfg, TrainConfig.from_dict(jcfg.to_dict())


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("train", [True, False])
def test_pipeline_arrays_equal_jax(tmp_path, train):
    jtask = JSyntheticTask(root=str(tmp_path / "j"), **TASK_ARGS)
    task = SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS)
    jp = JSlicePipeline(jtask, jtask.load_manifest("", train=train), 32, working_labels=train)
    tp = SlicePipeline(task, task.load_manifest("", train=train), 32, working_labels=train)
    for name in ("images", "scales", "fills"):
        for j, t in zip(getattr(jp, name), getattr(tp, name)):
            assert j.dtype == t.dtype and np.array_equal(j, t), name
    assert np.array_equal(jp.targets, tp.targets)
    assert jp.cases == tp.cases
    if train:
        for net in (1, 2):
            assert np.array_equal(jp.labels.get(net), tp.labels.get(net))


def test_device_batches_equal_host_batches(tmp_path):
    task = SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS)
    host = SlicePipeline(task, task.load_manifest("", train=True), 32, working_labels=True)
    dev = SlicePipeline(task, task.load_manifest("", train=True), 32, working_labels=True)
    dev.to_device("cpu")
    for a, b in zip(host.batches(3, rng=np.random.default_rng(1)),
                    dev.batches(3, rng=np.random.default_rng(1))):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        assert a["target1"].dtype == torch.int64
    assert dev.steps_per_epoch(3) == 2 and len(list(dev.batches(3))) == 2
    assert len(list(dev.batches(3, shuffle=False, drop_last=False))) == 3


def test_same_size_resize_matches_pil_without_importing_it():
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(16, 16, 3)).astype(np.float32)
    mask = rng.integers(0, 3, size=(16, 16)).astype(np.uint8)
    pil_img = np.asarray(
        Image.fromarray(img.astype(np.uint8)).resize((16, 16), Image.BILINEAR), np.float32
    )
    pil_mask = np.asarray(Image.fromarray(mask).resize((16, 16), Image.NEAREST), np.uint8)
    out_img = tbase.resize_image(img, 16)
    out_mask = tbase.resize_mask(mask, 16)
    assert out_img.dtype == np.float32 and np.array_equal(out_img, pil_img)
    assert out_mask.dtype == np.uint8 and np.array_equal(out_mask, pil_mask)
    assert out_mask is not mask
    # the short-circuit imports no PIL: run it where PIL cannot be imported
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from aide_tpu_torch.data.tasks.base import resize_image, resize_mask\n"
        "resize_image(np.zeros((8, 8, 3), np.float32), 8)\n"
        "resize_mask(np.zeros((8, 8), np.uint8), 8)\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


@pytest.fixture(scope="module")
def slice_metrics(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("slice")
    jcfg, cfg = _cfgs(tmp_path)
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(tmp_path / "j"), **TASK_ARGS))
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS), device="cpu")
    for n, net in enumerate(tr.state.nets):
        load_variables(net, _np_tree(jtr.state.net_variables(n)))

    def jax_views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(
            key, cfg.data.num_tta_views, batch, cfg.data.rotation_degree, cfg.data.hflip_prob
        )
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    tr.view_params = jax_views
    out = {}
    for name, trainer in (("jax", jtr), ("port", tr)):
        out[name] = {"train": trainer._train_epoch(0, 0.5), "test": trainer._test_epoch()}
    out["port_steps"] = tr.state.step
    return out


@pytest.mark.parametrize("phase", ["train", "test"])
def test_slice_epoch_metrics_match_jax(slice_metrics, phase):
    j, t = slice_metrics["jax"][phase], slice_metrics["port"][phase]
    assert set(t) == set(j) == {"loss1", "loss2", "dice1_sum", "dice2_sum"}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-3, err_msg=f"{phase} {k}")
    assert slice_metrics["port_steps"] == 2  # 8 slices, batch 4, drop_last


def test_trainer_without_device_raises_where_there_is_no_cuda(tmp_path, monkeypatch):
    _, cfg = _cfgs(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp_path / "t"), **TASK_ARGS))


def _port_modules():
    root = os.path.dirname(aide_tpu_torch.__file__)
    mods = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.dirname(root))
                mods.append(rel[:-3].replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax_in_a_fresh_process():
    mods = _port_modules()
    for m in ("ops.cuda_warp", "ops.cc", "engine.trainer", "engine.checkpoint",
              "engine.state", "engine.steps", "evaluation.case_eval", "core.logging",
              "data.io.png", "models.unet", "interop.weights", "cli.presets"):
        assert f"aide_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'aide_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|aide_tpu)(\.|\s|$)", re.M)
    root = os.path.dirname(aide_tpu_torch.__file__)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(fh.read())]
    assert len(files) > 20 and not hits, hits
