"""Case evaluation, largest-CC and PNG mask IO: the port against the JAX package.

On the CPU, with the same numpy inputs through both packages:
- ``ops.cc.keep_largest_connected_components`` equals the JAX package's on
  seeded random 2D and 3D masks, an empty mask, diagonal touching, and a
  tie between two largest components, where both keep the component whose
  last voxel comes first (the JAX package's native rule);
- ``score_case_volumes``, ``dice3d_np`` and ``pack_case_stream`` equal
  the JAX package's; ``Task.load_case_list`` reads a CSV as its does;
- ``make_predict_all``'s labels equal the JAX package's (unpacked) within
  0.1% of the pixels, from one weight set (FuseUNet base width 4, f32,
  32 px), and the per-batch path gives the same volumes as the whole-set one;
- the Pillow-free PNG module writes files that Pillow and the JAX reader
  read back equal, reads Pillow's (filtered) files and every row filter
  equal, and refuses other kinds of PNG.
"""

import io
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from aide_tpu import native
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.io import png as jpng
from aide_tpu.data.pipeline import SlicePipeline as JSlicePipeline
from aide_tpu.data.tasks.base import Task as JTask
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.evaluation import case_eval as jce
from aide_tpu.ops.cc import keep_largest_connected_components as jax_cc

from aide_tpu_torch.core import trace
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.data.io import png
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks.base import Task
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.evaluation import case_eval as tce
from aide_tpu_torch.interop.weights import load_variables
from aide_tpu_torch.ops.cc import keep_largest_connected_components as port_cc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TASK_ARGS = dict(
    two_modal=True, num_cases=3, slices_per_case=4, size=32,
    noisy_fraction=0.5, clean_cases=1, seed=3,
)


# ------------------------------ largest CC ------------------------------


def _tie_mask():
    """5x6: a vertical bar of 3 at column 0 and a horizontal bar of 3 at
    row 1, columns 2-4. The horizontal bar's last voxel comes first."""
    m = np.zeros((5, 6), np.uint8)
    m[0:3, 0] = 1
    m[1, 2:5] = 1
    return m


def _cc_masks():
    rng = np.random.default_rng(11)
    diag = np.zeros((6, 6), np.uint8)
    diag[1, 1] = diag[2, 2] = diag[3, 3] = 1  # touch at corners only: 3 components
    diag[4, 0:2] = 1
    diag3 = np.zeros((3, 4, 4), np.uint8)
    diag3[0, 0, 0] = diag3[1, 1, 1] = 1  # touch at a vertex only
    diag3[2, 2:4, 2] = 1
    return {
        "random_2d": (rng.random((40, 50)) < 0.45).astype(np.uint8),
        "random_2d_classes": rng.integers(0, 3, (30, 30)).astype(np.uint8) * (rng.random((30, 30)) < 0.5),
        "random_3d": (rng.random((6, 20, 24)) < 0.3).astype(np.uint8),
        "random_3d_dense": (rng.random((4, 16, 16)) < 0.55).astype(np.uint8),
        "empty_2d": np.zeros((8, 9), np.uint8),
        "empty_3d": np.zeros((2, 8, 9), np.uint8),
        "diagonal_2d": diag,
        "diagonal_3d": diag3,
    }


@pytest.mark.parametrize("name", sorted(_cc_masks()))
def test_cc_equals_jax(name):
    mask = _cc_masks()[name]
    got = port_cc(mask)
    want = jax_cc(mask)
    assert got.dtype == np.uint8 and got.shape == mask.shape
    assert np.array_equal(got, want), name


def test_cc_tie_keeps_the_component_whose_last_voxel_comes_first():
    if native.load() is None:
        pytest.skip("the JAX package's native CC library cannot be built here")
    mask = _tie_mask()
    want = np.zeros_like(mask)
    want[1, 2:5] = 1
    assert np.array_equal(port_cc(mask), want)
    assert np.array_equal(jax_cc(mask), want)
    # the same tie in 3D, across slices: the later-ending component loses
    vol = np.zeros((3, 5, 6), np.uint8)
    vol[:, 0, 0] = 1  # ends at slice 2
    vol[1, 3, 1:4] = 1  # ends at slice 1
    assert np.array_equal(port_cc(vol), jax_cc(vol))
    assert port_cc(vol)[1, 3, 1:4].all() and not port_cc(vol)[:, 0, 0].any()


# --------------------------- scoring, packing ---------------------------


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipes")
    jtask = JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS)
    task = SyntheticTask(root=str(tmp / "t"), **TASK_ARGS)
    jp = JSlicePipeline(jtask, jtask.load_manifest("", train=True), 32, working_labels=True)
    tp = SlicePipeline(task, task.load_manifest("", train=True), 32, working_labels=True)
    # make the working labels differ from the targets and between the nets
    rng = np.random.default_rng(5)
    for net in (1, 2):
        rows = rng.random(len(tp)) < 0.5
        lab = rng.integers(0, 2, (int(rows.sum()), 32, 32)).astype(np.uint8)
        jp.labels.get(net)[rows] = lab
        tp.labels.get(net)[rows] = lab
    return jp, tp


def test_dice3d_equals_jax():
    rng = np.random.default_rng(2)
    for shape in ((4, 8, 8), (1, 5, 7)):
        a = rng.integers(0, 3, shape).astype(np.uint8)
        b = rng.integers(0, 2, shape).astype(np.uint8)
        assert tce.dice3d_np(a, b) == jce.dice3d_np(a, b)
    z = np.zeros((2, 3, 3), np.uint8)
    assert tce.dice3d_np(z, z) == jce.dice3d_np(z, z) == 1.0


@pytest.mark.parametrize("target_net", [None, 1, 2, "self"])
def test_score_case_volumes_equals_jax(pipes, target_net):
    jp, tp = pipes
    rng = np.random.default_rng(7)
    cases = list(tp.cases)[::-1]
    volumes = [
        {n: rng.integers(0, 2, (len(tp.case_indices(c)), 32, 32)).astype(np.uint8) for n in (0, 1)}
        for c in cases
    ]
    kw = dict(target_net=target_net, full_metrics=True, keep_volumes=True)
    want = jce.score_case_volumes(jp, cases, volumes, dual=True, **kw)
    before = trace.totals()
    got = tce.score_case_volumes(tp, cases, volumes, **kw)
    assert set(got) == set(want) == {0, 1}
    assert {k: v[1] for k, v in trace.delta(before).items()} == {"cases.score": 1}
    for n in want:
        for g, w in zip(got[n], want[n]):
            assert (g.case_id, g.dice, g.iou, g.tp, g.tn, g.fp, g.fn) == (
                w.case_id, w.dice, w.iou, w.tp, w.tn, w.fp, w.fn)
            assert g.pred_volume is w.pred_volume or np.array_equal(g.pred_volume, w.pred_volume)


@pytest.mark.parametrize("batch_size", [1, 3, 4, 5, 32])
def test_pack_case_stream_equals_jax(pipes, batch_size):
    jp, tp = pipes
    for cases in (list(tp.cases), list(tp.cases)[::-1][:2], []):
        got = tce.pack_case_stream(tp, cases, batch_size)
        want = jce.pack_case_stream(jp, cases, batch_size)
        assert got[:3] == want[:3]
        assert np.array_equal(got[3], want[3])


def test_load_case_list_equals_jax(tmp_path):
    for name, col in (("ints", ["10", "37", "07"]), ("names", ["case01", "case10", "7"]),
                      ("floats", ["1.5", "2"])):
        path = tmp_path / f"{name}.csv"
        path.write_text("patient_case,extra\n" + "".join(f"{c},x\n" for c in col))
        assert Task.load_case_list(str(path)) == JTask.load_case_list(str(path)), name


# ------------------------------ predictions ------------------------------


@pytest.fixture(scope="module")
def predict_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="fuseunet", base_width=4, compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = 32
    jcfg.data.batch_size = 4
    jcfg.data.eval_batch_size = 3
    jcfg.data.num_tta_views = 2
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir = str(tmp / "ckpt")
    jcfg.history_dir = str(tmp / "hist")
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    jtr = JTrainer(jcfg, task=JSyntheticTask(root=str(tmp / "j"), **TASK_ARGS))
    tr = ttrainer.Trainer(cfg, SyntheticTask(root=str(tmp / "t"), **TASK_ARGS), device="cpu")
    for n, net in enumerate(tr.state.nets):
        load_variables(net, jax.tree_util.tree_map(np.asarray, jtr.state.net_variables(n)))
    return jtr, tr


def test_predict_all_labels_match_jax(predict_pair):
    jtr, tr = predict_pair
    _, _, _, padded = tce.pack_case_stream(tr.train_pipe, tr.train_pipe.cases, 5)
    idx_mat = padded.reshape(-1, 5).astype(np.int32)  # 12 slices and 3 pads
    packed = np.asarray(jtr.predict_all(jtr.state, jtr.train_pipe.device_image_data, idx_mat))
    want = np.unpackbits(packed, axis=-1, count=32)  # (N, 2, B, H, W)
    got = tr.predict_all(tr.state, tr.train_pipe.device_image_data, idx_mat)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    differ = np.count_nonzero(got.numpy() != want)
    assert differ <= 1e-3 * want.size, f"{differ} of {want.size} labels differ"
    # the labels are not trivial: both classes occur
    assert 0 < np.count_nonzero(want) < want.size


def test_case_inference_paths_agree(predict_pair):
    _, tr = predict_pair
    cases = list(tr.train_pipe.cases)
    kw = dict(batch_size=5, keep_largest_cc=True)
    before = trace.totals()
    whole = tce.start_case_inference(
        tr.predict_step, tr.state, tr.train_pipe, cases, predict_all=tr.predict_all, **kw)()
    spans = trace.delta(before)
    per_batch = tce.start_case_inference(tr.predict_step, tr.state, tr.train_pipe, cases, **kw)()
    assert len(whole) == len(per_batch) == len(cases)
    for a, b in zip(whole, per_batch):
        for net in (0, 1):
            assert a[net].dtype == np.uint8 and np.array_equal(a[net], b[net])
    # the dispatch, the wait for the labels and the largest component, once each
    assert {k: v[1] for k, v in spans.items()} == {"cases.dispatch": 1, "cases.fetch": 1,
                                                   "cases.cc": 1}


def test_bootstrap_skill_probe_matches_jax(predict_pair):
    jtr, tr = predict_pair
    for trainer in (jtr, tr):
        trainer.label_cases = {"case00", "case02"}
        trainer._bootstrap_skill_probe()
    want, got = jtr.engagement_probe, tr.engagement_probe
    assert set(got) == set(want) == {"bootstrap_skill1", "bootstrap_skill2"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


# ------------------------------ PNG masks ------------------------------


def _masks():
    rng = np.random.default_rng(4)
    return [
        rng.integers(0, 2, (32, 32)).astype(np.uint8),
        rng.integers(0, 5, (17, 29)).astype(np.uint8),
        np.zeros((1, 1), np.uint8),
        np.ones((256, 256), np.uint8),
    ]


@pytest.mark.parametrize("scale", [255, 63])
def test_png_written_by_the_port_reads_back_in_pil_and_jax(tmp_path, scale):
    for i, mask in enumerate(_masks()):
        path = str(tmp_path / f"m{i}.png")
        png.write_mask(path, mask, scale=scale)
        want = (mask * scale).astype(np.uint8)
        with Image.open(path) as img:
            assert img.mode == "L"
            assert np.array_equal(np.asarray(img), want)
        assert np.array_equal(jpng.read_mask(path), want)
        assert np.array_equal(png.read_mask(path), want)


def test_png_written_by_pil_reads_equal(tmp_path):
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:40, 0:48]
    images = [
        (rng.integers(0, 4, (40, 48)) * 63).astype(np.uint8),
        ((yy * 3 + xx * 5) % 256).astype(np.uint8),
        ((xx * yy) % 251).astype(np.uint8),
        rng.integers(0, 256, (40, 48)).astype(np.uint8),
    ]
    filters = set()
    for i, arr in enumerate(images):
        for level in (1, 6):
            path = str(tmp_path / f"p{i}_{level}.png")
            Image.fromarray(arr, mode="L").save(path, compress_level=level)
            assert np.array_equal(png.read_mask(path), arr)
            filters |= _row_filters(path)
            jpng.write_mask(path, arr // 63, scale=63)  # the JAX writer
            assert np.array_equal(png.read_mask(path), (arr // 63) * 63)
    assert len(filters) >= 3, filters  # Pillow filtered the rows adaptively


def _row_filters(path):
    with open(path, "rb") as fh:
        data = fh.read()
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        if data[pos + 4 : pos + 8] == b"IDAT":
            idat += data[pos + 8 : pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (w + 1)] for y in range(h)}


def _encode_rows(arr, kinds):
    """A grayscale PNG whose row y uses filter kinds[y % len(kinds)], each
    filter written from the PNG specification."""
    h, w = arr.shape
    a = arr.astype(np.int64)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        up = a[y - 1] if y else np.zeros(w, np.int64)
        left = np.concatenate([[0], a[y, :-1]])
        upleft = np.concatenate([[0], up[:-1]])
        if kind == 0:
            pred = np.zeros(w, np.int64)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(kind)
        out += ((a[y] - pred) % 256).astype(np.uint8).tobytes()
    return _png_bytes(w, h, 8, 0, bytes(out))


def _png_bytes(w, h, depth, colour, raw, interlace=0):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    comp = zlib.compress(raw)
    # two IDAT chunks: a reader must join them
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", comp[:5])
            + chunk(b"IDAT", comp[5:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_reads_every_row_filter(tmp_path, kinds):
    rng = np.random.default_rng(sum(kinds))
    arr = rng.integers(0, 256, (9, 13)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode_rows(arr, kinds))
    assert np.array_equal(png.read_mask(str(path)), arr)
    with Image.open(str(path)) as img:  # the encoder is a valid PNG writer
        assert np.array_equal(np.asarray(img), arr)


def test_png_refuses_other_kinds(tmp_path):
    """16-bit, interlaced and non-PNG files raise; RGB and palette files
    read as Pillow's convert("L") gives them (tests/test_torch_io.py has
    every mode)."""
    rgb = tmp_path / "rgb.png"
    rgb_arr = np.random.default_rng(0).integers(0, 256, (4, 5, 3)).astype(np.uint8)
    Image.fromarray(rgb_arr, mode="RGB").save(str(rgb))
    deep = tmp_path / "deep.png"
    deep.write_bytes(_png_bytes(3, 2, 16, 0, b"\x00" * (2 * 7)))
    laced = tmp_path / "laced.png"
    laced.write_bytes(_png_bytes(3, 2, 8, 0, b"\x00" * 8, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(np.arange(20, dtype=np.uint8).reshape(4, 5) * 12, mode="L").convert("P").save(
        buf, format="PNG")
    palette = tmp_path / "palette.png"
    palette.write_bytes(buf.getvalue())
    notpng = tmp_path / "x.png"
    notpng.write_bytes(b"GIF89a....")
    for path in (deep, laced, notpng):
        with pytest.raises(ValueError):
            png.read_mask(str(path))
    for path in (rgb, palette):
        with Image.open(str(path)) as img:
            assert np.array_equal(png.read_mask(str(path)), np.asarray(img.convert("L")))
