"""The port's bench (``aide_tpu_torch/bench.py``) against the JAX package's
``bench.py``, on the CPU at tiny points.

- ``make_config`` equal field for field to ``bench.make_config`` at every
  operating point, both variants (the output and cache paths excepted:
  each bench keeps its own);
- ``build_trainer``'s synthetic task built with the JAX bench's arguments
  at every point, and the tiny point's dataset decoded bit for bit alike,
  with the same labeled (clean) cases;
- the eval-volume line's schema, as ``tests/test_bench_script.py`` holds
  the JAX one;
- ``main([... "--device", "cpu"])`` at a tiny point, full and
  ``--steps-only``: every key the JAX bench prints for that mode (read from
  its source), the ``vs_baseline`` arithmetic, the ``partial`` marker;
- the model FLOPs of one real port step at a tiny FuseUNet point within 5%
  of the JAX package's lowering of the same step, built as
  ``bench.plain_flops_probe`` builds it (XLA's count includes elementwise
  work, the port's counts convolutions and matmuls);
- the peak table and the refusal without a card.

Tiny points are added to both benches' ``TASK_POINTS`` and removed after,
as ``tests/test_bench_script.py`` does; ``bench.py`` is not edited.
"""

import ast
import dataclasses
import json
import os
import re
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig

from aide_tpu_torch import bench as tbench
from aide_tpu_torch.core.config import ModelConfig, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("checkpoint_dir", "history_dir", "data.decode_cache_dir")
TINY = {
    # single-modal dual UNet-2 at 32 px: the epoch and main() tests
    "tiny": dict(model="unet2", img=32, two_modal=False, cases=4, slices=3, test_cases=2),
    # two-modal FuseUNet at 64 px (base width set on the config): the
    # dataset and FLOP tests
    "tinyfuse": dict(model="fuseunet", img=64, two_modal=True, cases=2, slices=4,
                     test_cases=1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jbench():
    sys.path.insert(0, REPO)
    import bench

    return bench


@pytest.fixture
def points(jbench):
    """The tiny points in both benches' TASK_POINTS, removed after."""
    for mod in (jbench, tbench):
        mod.TASK_POINTS.update(TINY)
    yield
    for mod in (jbench, tbench):
        for name in TINY:
            mod.TASK_POINTS.pop(name)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """The port bench's directories under this test's tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("variant", ["proposed", "comparison"])
@pytest.mark.parametrize("task", ["chaos", "kidney", "breast", "prostate"])
def test_make_config_matches_bench(jbench, task, variant):
    j = _flat(jbench.make_config(8, variant, task).to_dict())
    t = _flat(tbench.make_config(8, variant, task).to_dict())
    assert set(j) == set(t)
    assert {k: t[k] for k in t if k not in PATHS} == {k: j[k] for k in j if k not in PATHS}
    for key in PATHS:
        assert "aide_torch_bench_" in t[key] and t[key] != j[key]
    # the eval batch travels as in the JAX bench; the barrier knob keeps
    # the JAX bench's default, which the port's network does not read
    j = jbench.make_config(4, variant, task, eval_batch=12)
    t = tbench.make_config(4, variant, task, eval_batch=12)
    assert (t.data.eval_batch_size, t.model.packed_block_barrier) == (12, True)
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)


class _Recorder:
    """Stands in for both packages' Trainer: keeps what build_trainer gives
    it, builds nothing."""

    def __init__(self, cfg, task=None, device=None):
        self.cfg, self.task, self.device = cfg, task, device


def _tasks(jbench, monkeypatch, task_name):
    import aide_tpu.engine.trainer as jtrainer

    monkeypatch.setattr(jtrainer, "Trainer", _Recorder)
    monkeypatch.setattr(tbench, "Trainer", _Recorder)
    j = jbench.build_trainer(jbench.make_config(8, task=task_name), task_name)
    t = tbench.build_trainer(tbench.make_config(8, task=task_name), task_name, "cpu")
    return j, t


TASK_ATTRS = ("two_modal", "num_cases", "slices_per_case", "size", "noisy_fraction",
              "clean_cases", "noise_shift_divisor", "num_classes", "style", "seed",
              "domain_split", "test_case_offset", "num_test_cases", "tempmask_folder")


@pytest.mark.parametrize("task", ["chaos", "kidney", "breast", "prostate"])
def test_build_trainer_builds_the_bench_task(jbench, workdir, monkeypatch, task):
    j, t = _tasks(jbench, monkeypatch, task)
    for attr in TASK_ATTRS:
        assert getattr(t.task, attr) == getattr(j.task, attr), attr
    assert t.task.decode_fingerprint() == j.task.decode_fingerprint()
    assert t.label_cases == j.label_cases == {"case00"}
    assert t.task.root.startswith(str(workdir)) and t.device == "cpu"


def test_tiny_dataset_equals_the_bench_dataset_bit_for_bit(jbench, points, workdir,
                                                           monkeypatch):
    j, t = _tasks(jbench, monkeypatch, "tinyfuse")
    assert t.task.clean_case_ids() == j.task.clean_case_ids() == ["case00"]
    for train in (True, False):
        jspecs = j.task.load_manifest("", train=train)
        tspecs = t.task.load_manifest("", train=train)
        assert [s.sort_key for s in tspecs] == [s.sort_key for s in jspecs]
        assert len(tspecs) == (8 if train else 4)
        for js, ts in zip(jspecs, tspecs):
            (jimgs, jlabel), (timgs, tlabel) = j.task.decode(js), t.task.decode(ts)
            assert len(timgs) == len(jimgs) == 2
            for a, b in zip(timgs, jimgs):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tlabel, jlabel)


def _line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_eval_volume_schema(points, workdir, capsys):
    cfg = TrainConfig()
    cfg.model = ModelConfig(name="unet2", compute_dtype="float32", norm="group")
    cfg.data.task = "synthetic"
    cfg.data.variant = "proposed"
    cfg.data.img_size = 32
    cfg.data.batch_size = 4
    cfg.data.eval_batch_size = 8
    cfg.data.num_tta_views = 2
    cfg.checkpoint_dir = str(workdir / "ck")
    cfg.history_dir = str(workdir / "h")
    cfg.data.decode_cache_dir = ""
    trainer = tbench.build_trainer(cfg, "tiny", "cpu")
    rc = tbench.eval_volume_bench(trainer, cfg, types.SimpleNamespace(task="tiny"))
    assert rc == 0
    row = _line(capsys)
    assert row["metric"] == "tiny_eval_volume_seconds"
    assert row["unit"] == "s/volume"
    assert row["value"] > 0 and row["vs_baseline"] > 0
    assert row["value"] == pytest.approx(
        tbench.EVAL_VOLUME_BASELINE_S / row["vs_baseline"], rel=0.02)
    assert row["nets_evaluated"] == 2
    assert row["slices_per_volume"] == 3
    assert row["volumes_timed"] == 2 and row["img_size"] == 32
    assert 0 < row["amortized_volume_seconds"] <= row["value"] * 1.5
    assert "uint8" in row["includes"] and "bit-packed" not in row["includes"]
    # the host's largest-CC a volume: the native library and its plain twin
    # on the 2 cases x 2 nets raw predictions, equal
    assert row["cc_outputs_equal"] is True and row["cc_volumes"] == 4
    assert row["cc_native_ms_per_volume"] > 0 and row["cc_plain_ms_per_volume"] > 0


def _jax_keys(jbench) -> dict:
    """The keys the JAX bench prints, read from its source: the string keys
    of every dict literal in ``main`` but the backend-failure line, and the
    ``time_*`` keys of the JAX trainer's epoch row. By mode: the full epoch
    has ``full_epoch_includes`` and the row's phases, the steps-only line
    ``partial``."""
    with open(jbench.__file__) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            names = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "error" not in names:
                keys |= names
    import aide_tpu.engine.trainer as jtrainer

    with open(jtrainer.__file__) as fh:
        phases = set(re.findall(r'"(time_\w+)"', fh.read()))
    assert {"metric", "train_step_mfu", "mfu_basis", "partial"} <= keys
    assert {"time_train", "time_cases", "time_refresh"} <= phases
    return {"full": (keys - {"partial"}) | phases, "steps_only": keys - {"full_epoch_includes"}}


@pytest.mark.parametrize("mode", ["full", "steps_only"])
def test_main_prints_the_bench_keys(jbench, points, workdir, capsys, mode):
    argv = ["--task", "tiny", "--batch", "2", "--device", "cpu"]
    if mode == "steps_only":
        argv.append("--steps-only")
    else:
        argv += ["--profile", str(workdir / "prof")]
    assert tbench.main(argv) == 0
    row = _line(capsys)
    assert set(row) >= _jax_keys(jbench)[mode]
    assert row["metric"] == "tiny_coteach_epoch_seconds" and row["unit"] == "s/epoch"
    assert row["value"] > 0 and np.isfinite(row["value"])
    assert row["vs_baseline"] == pytest.approx(tbench.BASELINE_EPOCH_S / row["value"], rel=1e-9)
    # 12 train slices at batch 2; the epoch extrapolates over them (the
    # CHAOS point alone uses the reference's 984)
    assert row["train_steps_per_epoch"] == 6
    assert row["train_step_epoch_seconds"] == pytest.approx(12 * row["train_step_seconds"] / 2)
    assert row["mfu_basis"] == "model" and row["model_flops_per_step"] > 0
    assert row["train_step_model_tflops_per_s"] == row["train_step_tflops_per_s"] > 0
    # on the CPU: no card, so no peak, no MFU, no memory figure, and the
    # warp runs its plain version (no kernel launch)
    assert row["device_name"] == "cpu" and row["power_limit_w"] is None
    assert row["peak_tflops"] is None and row["train_step_mfu"] is None
    assert row["train_step_mfu_executed"] is None and row["peak_memory_bytes"] is None
    assert row["warp_launches_per_step"] == row["warp_launches_timed"] == 0
    assert row["graph_replays_timed"] == 0
    assert row["bare_steps"] == tbench.BARE_STEPS
    assert row["setup_seconds"] > 0 and row["block_barrier"] is True
    assert [r["epoch"] for r in row["history"]] == ([1] if mode == "steps_only" else [1, 2])
    for r in row["history"]:
        assert all(np.isfinite(v) for v in r.values()), r
    if mode == "steps_only":
        assert row["partial"] == "steps_only"
        assert row["value"] == row["train_step_epoch_seconds"]
    else:
        assert "partial" not in row
        assert row["full_epoch_includes"].endswith("refresh")
        assert row["value"] == row["history"][-1]["time"]
        # the profiler's window: 3 steps from the middle of the 6, the
        # warm-up step 0 and the steps around it untraced
        assert row["profile_traced_steps"] == [1, 2, 3]
        assert row["profile_trace_bytes"] == os.path.getsize(workdir / "prof" / "trace.json")
        # the traced steps' device time by program span: none on the CPU
        assert row["profile_spans"] == {"device_ms": {}, "idle_ms": {}, "kernel_ms": 0.0,
                                        "busy_ms": 0.0}
        with open(workdir / "prof" / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        assert {e["name"] for e in events if e.get("name", "").startswith("ProfilerStep#")} == {
            "ProfilerStep#1", "ProfilerStep#2", "ProfilerStep#3"}


def test_main_supervised_steps_only(points, workdir, capsys):
    argv = ["--task", "tiny", "--batch", "2", "--device", "cpu", "--supervised", "--steps-only"]
    assert tbench.main(argv) == 0
    row = _line(capsys)
    assert row["metric"] == "tiny_supervised_epoch_seconds"
    assert row["vs_baseline"] == pytest.approx(
        tbench.SUPERVISED_BASELINE_S / row["value"], rel=1e-9)
    assert row["partial"] == "steps_only" and row["warp_launches_per_step"] == 0
    assert set(row["history"][0]) >= {"train_loss", "traincase_dice1"}


def _jax_step_flops(jbench, variant: str) -> float:
    """The JAX lowering's FLOPs of the tinyfuse point's train step at base
    width 8, batch 2, built as ``bench.plain_flops_probe`` builds it."""
    from aide_tpu.engine import steps as steps_mod
    from aide_tpu.engine.state import DualTrainState, TrainState
    from aide_tpu.models import build_model
    from aide_tpu.ops.schedules import make_optimizer

    cfg = jbench.make_config(2, variant, "tinyfuse")
    cfg.model.packed = False
    cfg.model.base_width = 8
    size, batch = 64, 2
    model = build_model(cfg.model)
    x = jnp.zeros((1, size, size, 3))

    def make_state():
        tx = make_optimizer(cfg.optim, 123, cfg.num_epochs)
        if variant == "proposed":
            v1 = model.init(jax.random.key(0), x, x, train=False)
            v2 = model.init(jax.random.key(1), x, x, train=False)
            return DualTrainState.create(v1, v2, tx)
        return TrainState.create(model.init(jax.random.key(0), x, x, train=False), tx)

    state = jax.eval_shape(make_state)
    f32 = jnp.float32
    img = jax.ShapeDtypeStruct((batch, size, size, 3), f32)
    fill = jax.ShapeDtypeStruct((batch, 3), f32)
    tgt = jax.ShapeDtypeStruct((batch, size, size), jnp.int32)
    batch_d = {"modal1": img, "modal2": img, "fill1": fill, "fill2": fill}
    if variant == "proposed":
        batch_d.update(target1=tgt, target2=tgt)
        step = steps_mod.make_coteach_train_step(model, True, cfg)
        lowered = step.lower(state, batch_d, jax.random.key(0), jnp.asarray(0.5, f32))
    else:
        batch_d.update(target=tgt)
        step = steps_mod.make_supervised_train_step(model, True, cfg)
        lowered = step.lower(state, batch_d)
    an = lowered.cost_analysis()
    if isinstance(an, list):
        an = an[0]
    return float(an["flops"])


@pytest.mark.parametrize("variant", ["proposed", "comparison"])
def test_step_flops_match_the_jax_lowering(jbench, points, workdir, variant):
    cfg = tbench.make_config(2, variant, "tinyfuse")
    cfg.model.base_width = 8
    trainer = tbench.build_trainer(cfg, "tinyfuse", "cpu")
    dt, flops, (launches, replays) = tbench.time_bare_steps(trainer, cfg, iters=1)
    want = _jax_step_flops(jbench, variant)
    assert dt > 0 and launches == replays == 0
    # measured: 12,775,849,984 against 12,352,904,192 (1.034x) co-teaching
    assert flops == pytest.approx(want, rel=0.05), (flops, want, flops / want)


def test_peak_table_and_mfu():
    h100 = "NVIDIA H100 80GB HBM3"
    assert tbench.PEAK_TFLOPS[h100] == 989.5
    got = tbench.step_throughput(0.1, 13_011_603_423_232, h100)
    assert got["train_step_model_tflops_per_s"] == pytest.approx(130.11603423232)
    assert got["train_step_mfu"] == got["train_step_mfu_executed"] == pytest.approx(
        130.11603423232 / 989.5)
    assert got["peak_tflops"] == 989.5 and got["mfu_basis"] == "model"
    other = tbench.step_throughput(0.1, 13_011_603_423_232, "NVIDIA A100-SXM4-80GB")
    assert other["peak_tflops"] is None
    assert other["train_step_mfu"] is None and other["train_step_mfu_executed"] is None
    assert other["train_step_tflops_per_s"] == got["train_step_tflops_per_s"]


def test_bench_refuses_without_a_card(points, workdir, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--task", "tiny", "--batch", "2", "--steps-only"])
    # nothing built, cleared or printed before the refusal
    assert not os.listdir(workdir)
    assert capsys.readouterr().out == ""


# two cards of one host as nvidia-smi lists them, the second listed first
SMI = ("NVIDIA H100 80GB HBM3, 00000000:CA:00.0, GPU-7c1e0b2a-0000-4000-8000-00000000000b, 650.00 W\n"
       "NVIDIA H100 80GB HBM3, 00000000:18:00.0, GPU-7c1e0b2a-0000-4000-8000-00000000000a, 700.00 W\n")


@pytest.mark.parametrize("ids, want", [
    ({"00000000:18:00.0"}, 700.0),
    ({"00000000:CA:00.0"}, 650.0),
    ({"GPU-7C1E0B2A-0000-4000-8000-00000000000A"}, 700.0),
    ({"00000000:3B:00.0", "GPU-7C1E0B2A-0000-4000-8000-00000000000B"}, 650.0),
    ({"00000000:3B:00.0"}, None),
])
def test_power_limit_is_the_cards_own(ids, want):
    """The limit beside the numbers belongs to the card that ran them,
    found by its address or UUID, not to nvidia-smi's first line."""
    assert tbench.power_limit(SMI, ids) == want


def test_power_limit_without_a_number():
    line = "NVIDIA H100 80GB HBM3, 00000000:18:00.0, GPU-7C1E, [N/A]\n"
    assert tbench.power_limit(line, {"00000000:18:00.0"}) is None
    assert tbench.power_limit("", {"00000000:18:00.0"}) is None
