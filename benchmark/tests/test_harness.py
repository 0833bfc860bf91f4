"""The harness on the CPU: the manifest, discovery by name, the window's
rules and statistics, the kernel's byte function, the trace reduction and
the result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import kernels, manifest as mf, run, stats, trace
from benchmark.tests import tiny


def test_manifest_names_units_and_files():
    m = mf.load()
    assert mf.check(m) == []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[section]:
            assert mf.NAME.match(entry["name"]), entry["name"]
    for metric in m["end_to_end"] + m["per_layer"]:
        assert mf.UNIT.match(metric["unit"]), metric["unit"]
    for c in m["configs"]:
        assert mf.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(mf.ROOT, c["file"]))
    for w in m["workloads"]:
        assert mf.traffic(w["traffic"])["driver"] == "epochs"
        assert mf.limits(w["name"])
        mf.driver(mf.traffic(w["traffic"])["driver"])
    for metric in m["per_layer"]:
        assert callable(mf.reader(metric["name"]))
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e


@pytest.mark.parametrize("bad", [
    {"configs": [{"name": "a b"}], "workloads": [], "end_to_end": [], "per_layer": []},
    {"configs": [{"name": "c"}], "workloads": [{"name": "w", "config": "d", "traffic": "t"}],
     "end_to_end": [], "per_layer": []},
    {"configs": [], "workloads": [], "per_layer": [],
     "end_to_end": [{"name": "x", "unit": "tokens per s", "better": "lower"}]},
    {"configs": [], "workloads": [], "per_layer": [],
     "end_to_end": [{"name": "x", "unit": "s", "better": "less"}]},
])
def test_manifest_check_refuses(bad):
    assert mf.check(bad)


def test_whole_epoch_rule():
    clock = [0.0]
    lengths = iter([10.0, 14.0, 12.0, 9.0, 9.0])
    ran = []

    def epoch(e):
        ran.append(e)
        clock[0] += next(lengths)

    times = stats.whole_epochs(epoch, 5, 40.0, clock=lambda: clock[0])
    # 10 + 14 = 24; the third would end at 24 + 14 (the longest) = 38 <= 40
    # and does; the fourth would end at 36 + 14 = 50 > 40: three whole epochs
    assert times == [10.0, 14.0, 12.0]
    assert ran == [5, 6, 7]
    # the first epoch always runs, however long
    clock[0] = 0.0
    assert stats.whole_epochs(lambda e: clock.__setitem__(0, clock[0] + 99.0), 0, 40.0,
                              clock=lambda: clock[0]) == [99.0]


def test_percentile_and_spread():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_warp_bytes_match_the_chaos_row():
    # PERF.md: the CHAOS co-teaching step's bound is 50.08 us at 3.35 TB/s
    shapes = kernels.coteach_warp_launches(8, 4, 256, True)
    assert shapes == [(32, 256, 256, 3), (32, 256, 256, 3), (64, 256, 256, 2)]
    assert kernels.warp_bound_s(shapes, 3.35e12) * 1e6 == pytest.approx(50.08, abs=0.005)
    # one modality at 512 px (PERF.md's bench kidney row), 140.23 us
    shapes = kernels.coteach_warp_launches(8, 4, 512, False)
    assert kernels.warp_bound_s(shapes, 3.35e12) * 1e6 == pytest.approx(140.23, abs=0.005)


def test_trace_reduction_on_synthetic_events():
    kernels_ = [("conv", 0.0, 10.0), ("bn", 5.0, 15.0), ("conv", 30.0, 40.0),
                ("warp_rotate_flip_kernel", 50.0, 52.0)]
    host = [("step", -5.0, 60.0), ("aten::conv2d", 14.0, 29.0), ("aten::copy_", 41.0, 49.0)]
    assert trace.busy_us(kernels_) == pytest.approx(27.0)
    assert trace.kernel_us(kernels_, "warp_rotate_flip") == (2.0, 1)
    assert trace.top_ops(kernels_)[0] == ["conv", 20e-6]
    gaps = dict((n, s) for n, s in trace.idle_gaps(kernels_, host, 0.0, 60.0))
    # 15-30 under aten::conv2d, 40-50 under aten::copy_, 52-60 under step
    assert gaps["aten::conv2d"] == pytest.approx(15e-6)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["step"] == pytest.approx(8e-6)


def test_forbidden_modules_compare_top_level_names_whole():
    names = ["aide_tpu_torch", "aide_tpu_torch.ops", "jaxtyping", "numpy", "aide_tpu",
             "aide_tpu.ops.warp", "jax", "jaxlib.xla_client", "flax.linen"]
    assert run.forbidden_modules(names) == ["aide_tpu", "aide_tpu.ops.warp", "flax.linen",
                                            "jax", "jaxlib.xla_client"]


def test_result_line_keys_and_discovery_by_new_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    (and manifest entries) in a copy of the tree are found by name; the
    result has the contract's keys, ``checks`` last."""
    root = str(tmp_path)
    m = tiny.make_tree(root)
    c = mf.config("chaos_fuseunet32", root)
    c.update(name="new_fuse", slices_per_case=5)
    with open(os.path.join(root, "configs", "new_fuse.json"), "w") as fh:
        json.dump(c, fh)
    with open(os.path.join(root, "limits", "new_cell.json"), "w") as fh:
        json.dump({"limits": mf.limits("chaos_supervised_epoch", root)}, fh)
    with open(os.path.join(root, "metrics", "new.steps.py"), "w") as fh:
        fh.write("def read(record):\n    return float(record['steps_per_epoch'])\n")
    m["configs"].append({"name": "new_fuse"})
    m["workloads"].append({"name": "new_cell", "config": "new_fuse",
                           "traffic": "supervised_epochs", "chips": 1})
    m["per_layer"].append({"name": "new.steps", "unit": "steps", "better": "lower",
                           "workloads": ["new_cell"]})
    m["end_to_end"][0]["workloads"].append("new_cell")
    res = tiny.run_tiny(m, "new_cell", root, trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    # 4 cases x 5 slices in batches of 4: five steps an epoch
    assert res["metrics"]["new.steps"]["value"] == 5.0
    assert res["correct"] is True
    res = tiny.run_tiny(m, "new_cell", root)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"epoch_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in res["checks"].values():
        assert set(check) == {"value", "limit"}


def test_a_run_and_the_reference_load_no_jax(tmp_path):
    """A whole run in its own process, then the reference alone in another:
    neither loads JAX or the JAX package, and the reference loads nothing
    of the port."""
    root = str(tmp_path)
    tiny.make_tree(root)
    code = (
        "import json, sys, time, torch\n"
        "from benchmark import run\n"
        "from benchmark.tests import tiny\n"
        f"m = json.load(open({os.path.join(root, 'manifest.json')!r}))\n"
        f"tiny.run_tiny(m, 'chaos_coteach_epoch', {root!r})\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    code = (
        "import json, sys\n"
        "import benchmark.reference.data, benchmark.reference.evaluate\n"
        "import benchmark.reference.nets, benchmark.reference.steps\n"
        "import benchmark.reference.train, benchmark.reference.warp\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'aide_tpu', 'aide_tpu_torch'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=mf.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
