"""The port's command line and its checkpoint reader against aide_tpu's.

On the CPU (``--device cpu``), f32, 32 px:
- the standard-library msgpack decoder (``engine.checkpoint.msgpack_restore``)
  against ``flax.serialization.msgpack_restore`` on trees of f32, bf16,
  int32, uint8, bool and scalar leaves, nested and empty dicts, and leaves
  that flax writes in chunks;
- a JAX net export (``aide_tpu.engine.checkpoint.save_net`` of a BatchNorm
  UNet whose predictions hold both classes) through ``eval``, ``predict``
  and ``export`` of both CLIs on the same synthetic data: the same
  TP/TN/FP/FN, Dice and IoU within 1e-6, the same PNG masks and
  predictions, an exported state_dict equal to the JAX export's tensor by
  tensor, with the same ``epoch`` and ``loss``;
- ``write_case_csv`` byte for byte what the JAX package's pandas writer
  gives, ``summarize`` and its raise on no cases;
- ``presets``, the return code 2 without ``--checkpoint``/``--output``,
  repeated ``--set``, the refusal without a card (``eval``, ``export
  --format serve``);
- ``export --format serve --device cpu`` of the JAX net export at f32 and
  bf16 weights: bf16 under 0.75x f32, the header, probabilities summing to
  1 and equal to the JAX CLI's f32 artifact within 1e-4;
- a port ``train`` of a cut ``synthetic_smoke`` (GroupNorm) under
  ``--profile``, ``eval`` of its own best export, ``export`` refusing
  GroupNorm as a ``.pkl`` and serving it;
- a ``.msgpack`` net export as ``resume_file`` warm-starts both trainers;
  a ``*_full.msgpack`` one is refused.
"""

import argparse
import contextlib
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from aide_tpu.cli.main import main as jmain
from aide_tpu.cli.presets import get_preset as j_get_preset
from aide_tpu.engine import checkpoint as jckpt
from aide_tpu.evaluation import report as jreport
from aide_tpu.evaluation.case_eval import CaseResult as JCaseResult
from aide_tpu.interop import serving as jserving
from aide_tpu.models import build_model as j_build_model

from aide_tpu_torch.cli.main import _build_config, main
from aide_tpu_torch.cli.presets import get_preset
from aide_tpu_torch.data.io import png
from aide_tpu_torch.data.pipeline import SlicePipeline
from aide_tpu_torch.data.tasks import build_task
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import steps
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.evaluation import report
from aide_tpu_torch.evaluation.case_eval import CaseResult
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


# synthetic_supervised cut to a BatchNorm UNet-2 at 32 px on 2 train and 2
# held-out test cases of 4 slices
CUT = [
    "data.img_size=32", "model.name=unet2", "model.norm=batch",
    'data.task_options={"num_cases": 2, "slices_per_case": 4, '
    '"num_test_cases": 2, "test_case_offset": 100}',
]


# ------------------------------- msgpack -------------------------------


def _trees():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    return {
        "leaves": {
            "f32": f32,
            "bf16": jax.numpy.asarray(f32, jax.numpy.bfloat16),
            "i32": rng.integers(-1000, 1000, size=(5,), dtype=np.int32),
            "u8": rng.integers(0, 256, size=(2, 3, 4), dtype=np.uint8),
            "bool": np.array([True, False, True]),
            "f64": np.float64(2.5) * np.ones((2, 2)),
            "zero_d": np.array(7.0, np.float32),
        },
        "scalars": {
            "np_f32": np.float32(1.25), "np_i64": np.int64(-3), "py_int": 12345678901,
            "py_neg": -7, "py_float": 0.1, "py_str": "loss1", "py_true": True, "py_none": None,
            "big_uint": 2 ** 40,
        },
        "nested": {"a": {"b": {"c": f32[:1], "empty": {}}}, "empty": {}, "list": [1, 2.0, "x"]},
        "empty": {},
        "net": {"params": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
                                      "bias": np.zeros(8, np.float32)}},
                "batch_stats": {"BatchNorm_0": {"mean": np.ones(8, np.float32)}}},
    }


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":  # the port widens bf16 to f32
            w = w.astype(np.float32)
        assert type(got) is type(want) or isinstance(got, np.ndarray), path
        assert np.asarray(got).dtype == w.dtype and np.asarray(got).shape == w.shape, path
        assert np.array_equal(np.asarray(got), w), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("name", list(_trees()))
def test_msgpack_restore_matches_flax(name):
    data = serialization.msgpack_serialize(_trees()[name])
    _assert_tree_equal(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_restore_chunked_leaves(monkeypatch):
    """Leaves over flax's MAX_CHUNK_SIZE are written as chunk dicts; the
    port joins them back, as flax does."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = _trees()["net"]
    tree["bf16"] = jax.numpy.asarray(tree["params"]["Conv_0"]["kernel"], jax.numpy.bfloat16)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_tree_equal(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))
    # a whole tree that is one chunked array
    arr = np.arange(100, dtype=np.int32).reshape(4, 25)
    data = serialization.msgpack_serialize(arr)
    assert np.array_equal(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_restore_rejects_trailing_bytes():
    data = serialization.msgpack_serialize({"a": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="bytes after"):
        ckpt.msgpack_restore(data + b"\x00")


# ----------------------- a JAX net export, both CLIs -----------------------


def _common(root):
    return ["--preset", "synthetic_supervised", "--set", *CUT, f"data.root={root}"]


def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def _read_csv(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


def _masks(folder):
    out = {}
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".png"):
                out[os.path.relpath(os.path.join(dirpath, f), folder)] = png.read_mask(
                    os.path.join(dirpath, f))
    return out


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A JAX net export of a BatchNorm UNet-2 with moved BN statistics and a
    head that makes 20-40% of the test pixels foreground, leaning on the
    ellipses, saved by the JAX package with its sidecar."""
    tmp = tmp_path_factory.mktemp("export")
    jcfg = j_get_preset("synthetic_supervised").override(CUT)
    jm = j_build_model(jcfg.model)
    v = jax.tree_util.tree_map(np.array, jm.init(jax.random.key(3), np.zeros((1, 32, 32, 3)),
                                                 train=False))
    rng = np.random.default_rng(4)
    for leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        path, arr = leaf
        if str(path[-1]) == "['mean']":
            arr += rng.normal(0.0, 0.1, arr.shape).astype(np.float32)
        else:
            arr *= rng.uniform(0.8, 1.2, arr.shape).astype(np.float32)
    # the head bias from the port's logits on the port's test pipeline
    cfg = get_preset("synthetic_supervised").override(CUT + [f"data.root={tmp / 'probe'}"])
    net = build_model(cfg.model).eval()
    weights.load_variables(net, v)
    task = build_task(cfg)
    pipe = SlicePipeline(task, task.load_manifest(cfg.data.test_csv, train=False),
                         cfg.data.img_size, cfg.data.data_mean, cfg.data.data_std)
    batch = pipe.batch_at(np.arange(len(pipe)), images_only=True)
    with torch.no_grad():
        logits = net(*steps.batch_images(batch, False)).numpy()
    d = (logits[..., 1] - logits[..., 0]).ravel()
    head = v["params"]["Conv_0"]
    if np.corrcoef(d, pipe.targets.ravel())[0, 1] < 0:
        # swap the classes, so that the foreground leans on the ellipses
        head["kernel"], head["bias"] = head["kernel"][..., ::-1].copy(), head["bias"][::-1].copy()
        d = -d
    # the threshold in the widest gap between the sorted logit differences
    # from 60% to 80% background, so that every pixel's class is decided
    # well above f32 rounding
    d = np.sort(d)
    lo, hi = int(0.6 * d.size), int(0.8 * d.size)
    i = lo + int(np.argmax(np.diff(d[lo:hi])))
    shift = -0.5 * float(d[i] + d[i + 1])
    head["bias"][1] += shift
    margin = float(np.abs(d + shift).min() / np.abs(d).max())
    assert margin > 2e-5, margin
    path = str(tmp / "jaxrun_besttraincasedice.msgpack")
    jckpt.save_net(path, v, {"epoch": 7, "traincase_dice": 0.5, "loss": 0.4321, "dice_sum": 1.5})
    return dict(path=path, variables=v, tmp=tmp)


@pytest.fixture(scope="module")
def both_clis(jax_export):
    tmp, path = jax_export["tmp"], jax_export["path"]
    out = {}
    for name, fn, extra in (("jax", jmain, []), ("port", main, ["--device", "cpu"])):
        root, work = str(tmp / f"{name}_data"), tmp / name
        common = _common(root)
        rc_e, ev = _run(fn, ["eval", *common, "--checkpoint", path, "--output",
                             str(work / "eval"), *extra])
        rc_p, pr = _run(fn, ["predict", *common, "--checkpoint", path, "--output",
                             str(work / "pred"), *extra])
        rc_x, ex = _run(fn, ["export", *common, "--checkpoint", path, "--output",
                             str(work / "net.pkl")])
        out[name] = dict(rc=(rc_e, rc_p, rc_x), summary=json.loads(ev),
                         predict=json.loads(pr), export=json.loads(ex),
                         csv=_read_csv(str(work / "eval" / "jaxrun_besttraincasedice.csv")),
                         masks=_masks(str(work / "eval" / "generated_masks")),
                         preds=_masks(str(work / "pred")),
                         pkl=torch.load(str(work / "net.pkl"), map_location="cpu",
                                        weights_only=False))
    return out


def test_cli_eval_matches_jax(both_clis):
    j, t = both_clis["jax"], both_clis["port"]
    assert j["rc"] == t["rc"] == (0, 0, 0)
    assert t["csv"][0] == j["csv"][0] == "Patient_case,Dice,IoU,TP,TN,FP,FN"
    assert len(t["csv"][1]) == len(j["csv"][1]) == 2
    for tr, jr in zip(t["csv"][1], j["csv"][1]):
        assert tr[0] == jr[0]
        assert tr[3:] == jr[3:]  # TP, TN, FP, FN as written
        np.testing.assert_allclose([float(x) for x in tr[1:3]], [float(x) for x in jr[1:3]],
                                   rtol=0, atol=1e-6)
        tp, tn, fp, fn = map(float, tr[3:])
        assert tp > 0 and tn > 0 and fp + fn > 0  # both classes, imperfect
    assert t["summary"]["cases"] == j["summary"]["cases"] == 2
    for key in ("mean_dice", "mean_iou"):
        assert abs(t["summary"][key] - j["summary"][key]) <= 1e-6


def test_cli_eval_masks_match_jax(both_clis):
    j, t = both_clis["jax"]["masks"], both_clis["port"]["masks"]
    assert set(t) == set(j) and len(t) == 8
    for k in j:
        assert np.array_equal(t[k], j[k]), k
    assert any(m.any() for m in t.values())


def test_cli_predict_matches_jax(both_clis):
    j, t = both_clis["jax"], both_clis["port"]
    assert {k: v for k, v in t["predict"].items() if k != "output"} == {
        k: v for k, v in j["predict"].items() if k != "output"}
    assert set(t["preds"]) == set(j["preds"]) and len(t["preds"]) == 8
    for k in j["preds"]:
        assert np.array_equal(t["preds"][k], j["preds"][k]), k


def test_cli_export_matches_jax(both_clis):
    j, t = both_clis["jax"]["pkl"], both_clis["port"]["pkl"]
    assert set(t) == set(j) == {"net", "loss", "epoch"}
    assert t["epoch"] == j["epoch"] == 7
    assert t["loss"] == j["loss"] == pytest.approx(0.4321)
    assert list(t["net"]) == list(j["net"])
    for k, want in j["net"].items():
        got = t["net"][k]
        if k.endswith("num_batches_tracked"):
            # 0 in both; the port writes it 0-d as nn.BatchNorm2d does, the
            # JAX writer 1-d (np.ascontiguousarray widens a 0-d array), which
            # load_state_dict takes too
            assert got.shape == () and want.shape == (1,) and int(got) == int(want[0]) == 0, k
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert torch.equal(got, want), k


# --------------------------------- reports ---------------------------------

REPORT_ROWS = {
    "full": [dict(case_id="101", dice=0.8125, iou=0.6842105263157895, tp=13, tn=4070, fp=3, fn=3),
             dict(case_id="case_2", dice=1.0, iou=1.0, tp=0, tn=4096, fp=0, fn=0)],
    "dice_only": [dict(case_id="7", dice=0.123456789), dict(case_id="8", dice=0.0)],
    "missing": [dict(case_id="1", dice=0.5, iou=None, tp=None, tn=10, fp=2, fn=None),
                dict(case_id="2", dice=None, iou=0.25, tp=3, tn=11, fp=None, fn=4)],
    "numpy": [dict(case_id="3", dice=np.float64(2 / 3), iou=np.float64(0.5), tp=np.int64(2),
                   tn=np.int64(100), fp=np.int64(1), fn=np.int64(1))],
    "tiny": [dict(case_id="a,b", dice=1e-7, iou=1e20, tp=1.5, tn=0, fp=0, fn=0)],
}


@pytest.mark.parametrize("name", list(REPORT_ROWS))
def test_write_case_csv_byte_identical(tmp_path, name):
    rows = REPORT_ROWS[name]
    report.write_case_csv(str(tmp_path / "t" / "r.csv"), [CaseResult(**r) for r in rows])
    jreport.write_case_csv(str(tmp_path / "j" / "r.csv"), [JCaseResult(**r) for r in rows])
    got = (tmp_path / "t" / "r.csv").read_bytes()
    assert got == (tmp_path / "j" / "r.csv").read_bytes()
    assert got.startswith(b"Patient_case,Dice,IoU,TP,TN,FP,FN")


def test_summarize_and_masks_match_jax(tmp_path):
    rows = [dict(case_id="1", dice=0.5, iou=0.25), dict(case_id="2", dice=0.75, iou=0.5)]
    assert report.summarize([CaseResult(**r) for r in rows]) == jreport.summarize(
        [JCaseResult(**r) for r in rows])
    for fn in (report.summarize, jreport.summarize):
        with pytest.raises(ValueError, match="no cases"):
            fn([])
    vol = (np.random.default_rng(0).random((2, 8, 8)) < 0.4).astype(np.uint8)
    report.write_case_masks(str(tmp_path / "t"), "5", vol, ["a", "b"], scale=63)
    jreport.write_case_masks(str(tmp_path / "j"), "5", vol, ["a", "b"], scale=63)
    t, j = _masks(str(tmp_path / "t")), _masks(str(tmp_path / "j"))
    assert set(t) == set(j) == {"5/a.png", "5/b.png"}
    for k in t:
        assert np.array_equal(t[k], j[k]) and set(np.unique(t[k])) <= {0, 63}


# ------------------------------ the commands ------------------------------


def test_presets_command_matches_jax():
    rc_j, j = _run(jmain, ["presets"])
    rc_t, t = _run(main, ["presets"])
    assert rc_j == rc_t == 0 and t == j and "synthetic_smoke" in t


@pytest.mark.parametrize("argv", [
    ["eval"], ["predict"], ["export"], ["export", "--checkpoint", "x.pkl"],
    ["export", "--output", "x.pkl"],
], ids=["eval", "predict", "export", "export_no_output", "export_no_checkpoint"])
def test_missing_checkpoint_or_output_returns_2(tmp_path, argv):
    common = _common(str(tmp_path / "d"))
    extra = [] if argv[0] == "export" else ["--device", "cpu"]
    assert main(argv[:1] + common + argv[1:] + extra) == 2
    assert jmain(argv[:1] + common + argv[1:]) == 2


def test_repeated_set_flags_all_apply():
    ns = argparse.Namespace(config=None, preset="synthetic_supervised", data_root=".",
                            set=[["num_epochs=7"], ["data.img_size=48", "optim.lr=0.5"]])
    cfg = _build_config(ns)
    assert (cfg.num_epochs, cfg.data.img_size, cfg.optim.lr) == (7, 48, 0.5)


def test_cli_needs_the_card_unless_cpu_is_asked(jax_export):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    argv = ["eval", *_common(str(jax_export["tmp"] / "nodev")), "--checkpoint", jax_export["path"]]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["export", *argv[1:], "--output", str(jax_export["tmp"] / "x.serve"),
              "--format", "serve"])


def test_export_serve_of_a_jax_export(jax_export, tmp_path):
    """``export --format serve --device cpu`` of the JAX net export at f32
    and bf16 weights, as ``tests/test_cli.py`` holds the JAX CLI's: bf16
    under 0.75x the f32 artifact, the header's dtype, platforms and meta,
    probabilities (2, 32, 32, 2) summing to 1, equal to the JAX CLI's
    f32 artifact of the same export within 1e-4."""
    common = _common(str(tmp_path / "d"))
    for dtype in ("float32", "bfloat16"):
        rc, out = _run(main, ["export", *common, "--checkpoint", jax_export["path"], "--output",
                              str(tmp_path / f"{dtype}.serve"), "--format", "serve",
                              "--weights-dtype", dtype, "--device", "cpu"])
        assert rc == 0 and json.loads(out)["output"] == str(tmp_path / f"{dtype}.serve")
    sizes = {d: os.path.getsize(tmp_path / f"{d}.serve") for d in ("float32", "bfloat16")}
    assert sizes["bfloat16"] < 0.75 * sizes["float32"], sizes
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    probs = {}
    for dtype in sizes:
        call, header = serving.load_serving_artifact(str(tmp_path / f"{dtype}.serve"), "cpu")
        assert (header["weights_dtype"], header["platforms"]) == (dtype, ["cpu"])
        assert (header["model"], header["epoch"], header["img_size"]) == ("unet2", 7, 32)
        probs[dtype] = call(x).numpy()
        assert probs[dtype].shape == (2, 32, 32, 2)
        np.testing.assert_allclose(probs[dtype].sum(-1), 1.0, atol=1e-5)
    assert jmain(["export", *common, "--checkpoint", jax_export["path"], "--output",
                  str(tmp_path / "jax.serve"), "--format", "serve"]) == 0
    jcall, _ = jserving.load_serving_artifact(str(tmp_path / "jax.serve"))
    np.testing.assert_allclose(probs["float32"], np.asarray(jcall(x)), rtol=1e-4, atol=1e-4)


def test_load_net_names_what_does_not_fit(jax_export):
    for over, expect in ((dict(name="unet4"), "shape_mismatches=\\['"),
                         (dict(name="unet2", norm="group"), "missing=\\[\\]")):
        cfg = get_preset("synthetic_supervised").override(CUT)
        for k, val in over.items():
            setattr(cfg.model, k, val)
        with pytest.raises(ValueError, match="does not fit") as err:
            ckpt.load_net(jax_export["path"], build_model(cfg.model))
        assert "extra=" in str(err.value)
    # the right model loads what variables_to_state_dict gives
    cfg = get_preset("synthetic_supervised").override(CUT)
    net = build_model(cfg.model)
    sd = ckpt.load_net(jax_export["path"], net)
    want = weights.variables_to_state_dict(jax_export["variables"], "unet2")
    assert set(sd) == set(want) == set(net.state_dict())
    for k in want:
        assert np.array_equal(sd[k].numpy(), want[k]), k


def test_cli_train_then_eval_own_export(tmp_path):
    """``train`` of synthetic_smoke cut to UNet-2 at 32 px on 4 cases of 4
    slices, one epoch under --profile, then ``eval`` of its own best export
    of net 1; ``export`` refuses the GroupNorm net as a ``.pkl`` and
    writes its serving artifact."""
    work = str(tmp_path)
    common = [
        "--preset", "synthetic_smoke", "--set", f"data.root={work}/data",
        f"checkpoint_dir={work}/ckpt", f"history_dir={work}/hist",
        "data.img_size=32", "model.base_width=2",
        'data.task_options={"num_cases": 4, "slices_per_case": 4}',
    ]
    rc, out = _run(main, ["train", *common, "--epochs", "1", "--device", "cpu",
                          "--profile", f"{work}/prof"])
    assert rc == 0 and json.loads(out)["profile_dir"] == f"{work}/prof"
    (trace,) = [f for f in os.listdir(f"{work}/prof") if f.endswith(".json")]
    with open(f"{work}/prof/{trace}") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    # the program's spans are in the written trace, beside the ops
    assert {"train.step", "step.views", "train.data", "epoch.cases", "refresh.write"} <= names
    cfg = get_preset("synthetic_smoke")
    with open(f"{work}/hist/{cfg.experiment_name}_history.json") as fh:
        history = json.load(fh)
    assert len(history) == 1 and all(np.isfinite(v) for v in history[0].values())
    best = ckpt.best_net_path(f"{work}/ckpt", cfg.experiment_name, 1)
    assert os.path.exists(best)
    rc, out = _run(main, ["eval", *common, "--checkpoint", best, "--output", f"{work}/eval",
                          "--device", "cpu"])
    assert rc == 0 and json.loads(out)["cases"] == 4
    header, rows = _read_csv(f"{work}/eval/{os.path.basename(best).split('.')[0]}.csv")
    assert header == "Patient_case,Dice,IoU,TP,TN,FP,FN" and len(rows) == 4
    assert len(_masks(f"{work}/eval/generated_masks")) == 16
    with pytest.raises(ValueError, match="norm='batch'"):
        main(["export", *common, "--checkpoint", best, "--output", f"{work}/x.pkl"])
    # the serving export takes GroupNorm, as the JAX package's does
    rc, _ = _run(main, ["export", *common, "--checkpoint", best, "--output", f"{work}/x.serve",
                        "--format", "serve", "--device", "cpu"])
    call, header = serving.load_serving_artifact(f"{work}/x.serve", "cpu")
    assert rc == 0 and header["model"] == cfg.model.name and header["img_size"] == 32
    np.testing.assert_allclose(call(np.zeros((1, 32, 32, 3), np.float32)).sum(-1).numpy(), 1.0,
                               atol=1e-5)


def test_msgpack_net_export_warm_starts(jax_export, tmp_path):
    """A JAX ``.msgpack`` net export as ``resume_file``: the supervised net
    takes it as it is, the co-teaching pair takes it plus noise with its BN
    statistics unchanged; a ``*_full.msgpack`` file is read as an exact
    resume: a net export under that name does not fit the train state, and
    a train state saved there comes back as it was."""
    want = weights.variables_to_state_dict(jax_export["variables"], "unet2")
    sup = get_preset("synthetic_supervised").override(CUT + [
        f"data.root={tmp_path}/s", f"checkpoint_dir={tmp_path}/c", f"history_dir={tmp_path}/h",
        f"resume_file={jax_export['path']}"])
    tr = ttrainer.Trainer(sup, device="cpu")
    for k, v in tr.state.nets[0].state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k
    dual = sup.override(["data.variant=proposed", "coteach.enabled=true"])
    tr = ttrainer.Trainer(dual, device="cpu")
    assert tr.dual
    for net in tr.state.nets:
        sd = net.state_dict()
        for k, v in want.items():
            if "running" in k:
                assert np.array_equal(sd[k].numpy(), v), k
        moved = [k for k in want if k.endswith("conv1.weight")]
        assert all(0 < np.abs(sd[k].numpy() - want[k]).max() < 0.05 for k in moved)
    sup_tr = ttrainer.Trainer(sup, device="cpu")
    for name in ("jaxrun_full.msgpack", "jaxrun_last_full.msgpack"):
        shutil.copy(jax_export["path"], tmp_path / name)
        with pytest.raises(ValueError, match="does not fit this train state"):
            ttrainer.Trainer(sup.override([f"resume_file={tmp_path / name}"]), device="cpu")
        ckpt.save_train_state(str(tmp_path / name), sup_tr.state, {"next_epoch": 3})
        tr = ttrainer.Trainer(sup.override([f"resume_file={tmp_path / name}"]), device="cpu")
        assert tr.start_epoch == 3
        for k, v in tr.state.nets[0].state_dict().items():
            assert np.array_equal(v.numpy(), want[k]), k
