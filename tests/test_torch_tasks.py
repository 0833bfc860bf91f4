"""The port's CHAOS, prostate, kidney and breast tasks against the JAX package's.

Each task reads a small fixture tree in its native formats (DICOM pairs and
palette PNG masks; NRRD volumes; single-slice NIfTI images with three
annotators; NIfTI volumes with segmentation masks and noisy PNG folders),
written by ``aide_tpu_torch.data.fixtures`` at the paths its preset names,
at a native size other than ``img_size`` (32 px), so every resize runs.
The bars:
- manifests: the same ``SliceSpec``s field by field (and the same repr, the
  decode cache's key);
- ``SlicePipeline``: images, ``scales`` and targets exact, ``fills`` within
  1e-6, working labels exact;
- tempmasks: each package reads back the other's, through a fresh
  pipeline's working labels (prostate: the img_size -> native -> img_size
  round trip), at the same paths;
- ``write_case_predictions``: the same files with the same arrays;
- ``build_task``: the same class and options; unknown options raise
  TypeError in both;
- the decode cache: a cache written by either package serves the other;
- one prostate proposed epoch of ``Trainer(cfg)`` with no task (UNet-4,
  BatchNorm, f32, 32 px) against the JAX trainer's from the same weights
  and views: the same ``refresh_log``, history within rtol 1e-3 (1e-3
  absolute for dice values) and equal NRRD tempmask volumes.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import TrainConfig as JTrainConfig
from aide_tpu.data.io import nifti as jnifti
from aide_tpu.data.io import nrrd as jnrrd
from aide_tpu.data.io import png as jpng
from aide_tpu.data.pipeline import SlicePipeline as JSlicePipeline
from aide_tpu.data.tasks import build_task as jbuild_task
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.cli.presets import get_preset
from aide_tpu_torch.data import pipeline as tpipeline
from aide_tpu_torch.data.fixtures import write_fixture_tree
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks import TASKS, build_task
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


SIZE = 32
PRESETS = {
    "chaos": ("chaos_proposed_30cases1labeled", 40),
    "prostate": ("prostate_proposed_isbi3t_transfer_isbidx", 40),
    "kidney": ("kidney_proposed_mask1", 37),
    "breast": ("breast_proposed_272cases25labeled", 48),
}
TASK_NAMES = sorted(PRESETS)


def _tree(root, task, **kw):
    """The preset's config with its fixture tree written under ``root``,
    at img_size 32."""
    preset, native = PRESETS[task]
    cfg = get_preset(preset, str(root))
    cfg.data.img_size = SIZE
    args = dict(train_cases=3, test_cases=1, slices=3, size=native, seed=5)
    args.update(kw)
    write_fixture_tree(cfg, **args)
    return cfg


def _jcfg(cfg):
    return JTrainConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {task: _tree(root / task, task) for task in TASK_NAMES}


def _splits(cfg):
    return ((cfg.data.train_csv, True), (cfg.data.test_csv, False))


@pytest.mark.parametrize("task", TASK_NAMES)
def test_manifests_match(trees, task):
    cfg = trees[task]
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    for csv_path, train in _splits(cfg):
        got, want = t.load_manifest(csv_path, train), jt.load_manifest(csv_path, train)
        assert len(got) == len(want) > 0
        assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
        assert [repr(s) for s in got] == [repr(s) for s in want]


def _pipes(cfg, train, **kw):
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    csv_path = cfg.data.train_csv if train else cfg.data.test_csv
    pipe = SlicePipeline(t, t.load_manifest(csv_path, train), SIZE, working_labels=train, **kw)
    jpipe = JSlicePipeline(jt, jt.load_manifest(csv_path, train), SIZE, working_labels=train, **kw)
    return pipe, jpipe


def _assert_pipes_equal(pipe, jpipe):
    assert len(pipe.images) == len(jpipe.images)
    for m in range(len(pipe.images)):
        np.testing.assert_array_equal(pipe.images[m], jpipe.images[m])
        np.testing.assert_array_equal(pipe.scales[m], jpipe.scales[m])
        np.testing.assert_allclose(pipe.fills[m], jpipe.fills[m], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pipe.targets, jpipe.targets)
    assert pipe.cases == jpipe.cases and pipe.case_slices == jpipe.case_slices


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("task", TASK_NAMES)
def test_pipelines_match(trees, task, train):
    pipe, jpipe = _pipes(trees[task], train)
    _assert_pipes_equal(pipe, jpipe)
    assert pipe.targets.any() and pipe.images[0].shape == (len(pipe), SIZE, SIZE, 3)
    if train:
        for net in (1, 2):
            np.testing.assert_array_equal(pipe.labels.get(net), jpipe.labels.get(net))


def _refresh(pipe, case, net, seed):
    idxs = pipe.case_indices(case)
    vol = (np.random.default_rng(seed).random((len(idxs), SIZE, SIZE)) > 0.6).astype(np.uint8)
    vol[:, 8:20, 10:24] = 1
    pipe.labels.refresh_case(net, idxs, vol)
    return idxs


@pytest.mark.parametrize("task", TASK_NAMES)
def test_tempmasks_read_across_packages(tmp_path, task):
    """The port writes net 1's refresh of one case and the JAX package net
    2's of another; fresh pipelines of both packages then hold the same
    working labels, and the files sit at the same paths."""
    cfg = _tree(tmp_path / "tree", task)
    pipe, jpipe = _pipes(cfg, True)
    cases = pipe.cases
    idx1 = _refresh(pipe, cases[0], 1, seed=1)
    _refresh(jpipe, cases[-1], 2, seed=2)
    for i in idx1:
        assert pipe.task.tempmask_path(pipe.specs[i], 1) == jpipe.task.tempmask_path(jpipe.specs[i], 1)
        assert os.path.exists(pipe.task.tempmask_path(pipe.specs[i], 1))
    fresh, jfresh = _pipes(cfg, True)
    for net in (1, 2):
        np.testing.assert_array_equal(fresh.labels.get(net), jfresh.labels.get(net))
    # the refreshed rows came from disk, not from the targets
    assert not np.array_equal(fresh.labels.get(1)[idx1], fresh.targets[idx1])
    if task != "prostate":  # same resolution on disk: read back as written
        np.testing.assert_array_equal(fresh.labels.get(1)[idx1], pipe.labels.get(1)[idx1])


def test_prostate_round_trip_is_resize_of_resize(tmp_path):
    """The prostate mirror stores refreshed slices at the native size; the
    working labels read back are resize_mask(resize_mask(label, native),
    img_size), in both packages."""
    from aide_tpu_torch.data.tasks.base import resize_mask

    cfg = _tree(tmp_path / "tree", "prostate")
    pipe, _ = _pipes(cfg, True)
    idxs = _refresh(pipe, pipe.cases[0], 1, seed=3)
    fresh, jfresh = _pipes(cfg, True)
    want = np.stack([resize_mask(resize_mask(pipe.labels.get(1)[i], (40, 40)), SIZE) for i in idxs])
    np.testing.assert_array_equal(fresh.labels.get(1)[idxs], want)
    np.testing.assert_array_equal(jfresh.labels.get(1)[idxs], want)


def _read_any(path):
    if path.endswith(".png"):
        return jpng.read_mask(path)
    if path.endswith(".nrrd"):
        return jnrrd.read_nrrd(path)[0]
    return jnifti.read_nifti(path)


@pytest.mark.parametrize("task", TASK_NAMES)
def test_write_case_predictions_match(trees, tmp_path, task):
    cfg = trees[task]
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    specs = t.load_manifest(cfg.data.test_csv, train=False)
    jspecs = jt.load_manifest(cfg.data.test_csv, train=False)
    case = specs[0].case_id
    case_specs = [s for s in specs if s.case_id == case]
    vol = (np.random.default_rng(4).random((len(case_specs), SIZE, SIZE)) > 0.5).astype(np.uint8)
    t.write_case_predictions(str(tmp_path / "port"), case, case_specs, vol)
    jt.write_case_predictions(str(tmp_path / "jax"), case, [s for s in jspecs if s.case_id == case], vol)
    files = {
        side: sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                     for d, _, fs in os.walk(tmp_path / side) for f in fs)
        for side in ("port", "jax")
    }
    assert files["port"] == files["jax"] and files["port"]
    for rel in files["port"]:
        np.testing.assert_array_equal(_read_any(str(tmp_path / "port" / rel)),
                                      _read_any(str(tmp_path / "jax" / rel)))


@pytest.mark.parametrize("task", TASK_NAMES + ["synthetic"])
def test_build_task_matches(trees, tmp_path, task):
    if task == "synthetic":
        cfg = get_preset("synthetic_smoke", str(tmp_path))
        cfg.data.root = str(tmp_path / "synthetic")
    else:
        cfg = trees[task]
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    assert type(t).__name__ == type(jt).__name__ and type(t) is TASKS.get(task)
    assert t.decode_fingerprint() == jt.decode_fingerprint()
    for attr in ("root", "tempmask_folder", "two_modal", "window", "mask_identity"):
        assert getattr(t, attr, None) == getattr(jt, attr, None), attr


@pytest.mark.parametrize("task", TASK_NAMES)
def test_unknown_task_option_raises(trees, task):
    cfg = dataclasses.replace(trees[task])
    cfg.data = dataclasses.replace(cfg.data, task_options={"windw": "max"})
    for build, c in ((build_task, cfg), (jbuild_task, _jcfg(cfg))):
        with pytest.raises(TypeError, match="unknown task options"):
            build(c)


def test_chaos_window_max_and_kidney_annotator(trees):
    for task, options in (("chaos", {"window": "max"}), ("kidney", {})):
        cfg = dataclasses.replace(trees[task])
        cfg.data = dataclasses.replace(cfg.data, task_options=options, mask_identity=2)
        pipe, jpipe = _pipes(cfg, True)
        _assert_pipes_equal(pipe, jpipe)
        base, _ = _pipes(trees[task], True)
        # another window, another annotator: other arrays
        changed = pipe.images[0] if task == "chaos" else pipe.targets
        assert not np.array_equal(changed, base.images[0] if task == "chaos" else base.targets)


def test_kidney_unlabeled_manifest_and_vote(trees, tmp_path):
    cfg = trees["kidney"]
    csv_path = str(tmp_path / "images_only.csv")
    with open(cfg.data.test_csv) as fh:
        rows = [line.split(",")[0] for line in fh.read().splitlines()]
    with open(csv_path, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    got, want = t.load_manifest(csv_path), jt.load_manifest(csv_path)
    assert [dataclasses.asdict(s) for s in got] == [dataclasses.asdict(s) for s in want]
    assert got[0].extras == {"train": False, "unlabeled": True} and got[0].mask_path == ""
    (img,), mask = t.decode(got[0])
    (jimg,), jmask = jt.decode(want[0])
    np.testing.assert_array_equal(img, jimg)
    assert not mask.any() and np.array_equal(mask, jmask)
    # the test split votes: the mean of the three annotators above 0.5
    spec = t.load_manifest(cfg.data.test_csv, train=False)[0]
    _, vote = t.decode(spec)
    masks = [jnifti.read_nifti(os.path.join(cfg.data.root, p))[0] for p in spec.extras["all_masks"]]
    np.testing.assert_array_equal(vote, (np.mean(masks, axis=0) > 0.5).astype(np.uint8))


@pytest.mark.parametrize("fault", ["mask stem", "instance number"])
def test_chaos_alignment_errors(trees, tmp_path, fault):
    cfg = trees["chaos"]
    with open(cfg.data.test_csv) as fh:
        lines = fh.read().splitlines()
    inphase, outphase, mask = lines[1].split(",")
    if fault == "mask stem":
        mask = mask.replace("-00002.png", "-00004.png")
    else:
        outphase = outphase.replace("-00001.dcm", "-00003.dcm")
    csv_path = str(tmp_path / "bad.csv")
    with open(csv_path, "w") as fh:
        fh.write("\n".join([lines[0], f"{inphase},{outphase},{mask}"]) + "\n")
    errors = []
    for t in (build_task(cfg), jbuild_task(_jcfg(cfg))):
        with pytest.raises(ValueError, match="mismatch|misalignment") as info:
            t.load_manifest(csv_path)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


# ---------------------------- decode cache ----------------------------


def _no_decode(task):
    def refuse(spec):
        raise AssertionError("decoded although the cache holds the arrays")

    task.decode = refuse
    return task


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_decode_cache_read_across_packages(trees, tmp_path, writer):
    cfg = trees["prostate"]
    cache = str(tmp_path / "cache")
    t, jt = build_task(cfg), jbuild_task(_jcfg(cfg))
    specs, jspecs = t.load_manifest(cfg.data.train_csv), jt.load_manifest(cfg.data.train_csv)
    if writer == "jax":
        first = JSlicePipeline(jt, jspecs, SIZE, cache_dir=cache)
        second = SlicePipeline(_no_decode(t), specs, SIZE, cache_dir=cache)
    else:
        first = SlicePipeline(t, specs, SIZE, cache_dir=cache)
        second = JSlicePipeline(_no_decode(jt), jspecs, SIZE, cache_dir=cache)
    assert len(os.listdir(cache)) == 1
    _assert_pipes_equal(second, first) if writer == "jax" else _assert_pipes_equal(first, second)


def test_decode_cache_key_and_upkeep(trees, tmp_path, monkeypatch):
    """The key is the JAX package's; the content signature stats the spec
    paths as given, so from another directory the real tasks' relative
    paths read "?" and a rewritten mask does not change the key (reference
    behaviour, ported as it is), while from the root it does. A corrupt
    cache file is decoded anew, and a new file prunes its stale siblings."""
    cfg = trees["breast"]
    cache = str(tmp_path / "cache")
    t = build_task(cfg)
    specs = t.load_manifest(cfg.data.train_csv)
    prefix, path = tpipeline.decode_cache_path(cache, t, specs, SIZE, None, None)
    monkeypatch.chdir(cfg.data.root)
    _, path_at_root = tpipeline.decode_cache_path(cache, t, specs, SIZE, None, None)
    assert path_at_root != path and path_at_root.startswith(prefix)
    monkeypatch.chdir(tmp_path)
    SlicePipeline(t, specs, SIZE, cache_dir=cache)
    assert os.listdir(cache) == [os.path.basename(path)]
    # the key JAX derives names the same file: it decodes nothing
    jt = jbuild_task(_jcfg(cfg))
    JSlicePipeline(_no_decode(jt), jt.load_manifest(cfg.data.train_csv), SIZE, cache_dir=cache)
    # a corrupt or truncated file: decoded anew and rewritten
    with open(path, "rb") as fh:
        whole = fh.read()
    for junk in (b"not a zip", whole[: len(whole) // 2]):
        with open(path, "wb") as fh:
            fh.write(junk)
        fresh = SlicePipeline(build_task(cfg), specs, SIZE, cache_dir=cache)
        _assert_pipes_equal(fresh, SlicePipeline(build_task(cfg), specs, SIZE))
        _assert_pipes_equal(SlicePipeline(_no_decode(build_task(cfg)), specs, SIZE, cache_dir=cache), fresh)
    # a file of the same identity under another signature is pruned
    stale = f"{prefix}0123456789abcdef.npz"
    shutil.copy(path, stale)
    os.remove(path)
    SlicePipeline(build_task(cfg), specs, SIZE, cache_dir=cache)
    assert os.listdir(cache) == [os.path.basename(path)]


# ------------------------ the prostate epoch ------------------------


def _epoch_cfg(root):
    cfg = _tree(root, "prostate", train_cases=2, test_cases=1, slices=4, labeled=0)
    cfg.model.name = "unet4"
    cfg.model.compute_dtype = "float32"
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 4
    cfg.data.num_tta_views = 2
    cfg.optim.lr = 1e-6
    cfg.coteach.warmup_epochs = 1
    cfg.coteach.update_percent = 0.5  # 2 cases: the worst one a net
    cfg.mesh.num_devices = 1
    cfg.checkpoint_dir = str(root / "ckpt")
    cfg.history_dir = str(root / "hist")
    return cfg


def test_prostate_epoch_matches_jax(tmp_path):
    """One proposed epoch of ``Trainer(cfg)`` with no task, each package on
    its own copy of the same tree, from the JAX nets' weights and views."""
    cfg, jcfg = _epoch_cfg(tmp_path / "port"), _jcfg(_epoch_cfg(tmp_path / "jax"))
    jtr = JTrainer(jcfg)
    tr = ttrainer.Trainer(cfg, device="cpu")
    assert type(tr.task).__name__ == "ProstateTask" and tr.dual
    for n, net in enumerate(tr.state.nets):
        load_variables(net, jax.tree_util.tree_map(np.asarray, jtr.state.net_variables(n)))

    def jax_views(epoch, step, batch):
        key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
        d, h = jtta.sample_view_params(
            key, cfg.data.num_tta_views, batch, cfg.data.rotation_degree, cfg.data.hflip_prob)
        return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

    tr.view_params = jax_views
    jhist, hist = jtr.run(1), tr.run(1)
    assert tr.refresh_log == jtr.refresh_log
    assert any(rewritten for *_, rewritten in tr.refresh_log)
    for key, want in jhist[0].items():
        if not key.startswith("time") and key != "epoch":
            np.testing.assert_allclose(hist[0][key], want, rtol=1e-3,
                                       atol=1e-3 if "dice" in key else 0.0, err_msg=key)
    folder = os.path.join(cfg.data.root, cfg.data.tempmask_folder)
    jfolder = os.path.join(jcfg.data.root, jcfg.data.tempmask_folder)
    names = sorted(os.listdir(folder))
    assert names == sorted(os.listdir(jfolder)) and names
    for name in names:
        assert name.endswith(".nrrd")
        np.testing.assert_array_equal(jnrrd.read_nrrd(os.path.join(folder, name))[0],
                                      jnrrd.read_nrrd(os.path.join(jfolder, name))[0])


def test_tasks_need_neither_pillow_nor_pandas(tmp_path):
    """Every task decodes its tree, resizing, and refreshes its tempmasks in
    a process where PIL and pandas cannot be imported."""
    import subprocess
    import sys

    code = f"""
import sys
sys.modules['PIL'] = None
sys.modules['pandas'] = None
import numpy as np
from aide_tpu_torch.cli.presets import get_preset
from aide_tpu_torch.data.fixtures import write_fixture_tree
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks import build_task
for task, (preset, native) in {PRESETS!r}.items():
    cfg = get_preset(preset, {str(tmp_path)!r} + '/' + task)
    write_fixture_tree(cfg, train_cases=2, test_cases=1, slices=2, size=native, seed=1)
    t = build_task(cfg)
    pipe = SlicePipeline(t, t.load_manifest(cfg.data.train_csv), 32, working_labels=True)
    idxs = pipe.case_indices(pipe.cases[0])
    pipe.labels.refresh_case(1, idxs, np.ones((len(idxs), 32, 32), np.uint8))
    fresh = SlicePipeline(t, t.load_manifest(cfg.data.train_csv), 32, working_labels=True)
    assert fresh.labels.get(1)[idxs].all(), task
    SlicePipeline(t, t.load_manifest(cfg.data.test_csv, train=False), 32)
assert not any(m.split('.')[0] in ('PIL', 'pandas') for m in sys.modules if sys.modules[m] is not None)
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
