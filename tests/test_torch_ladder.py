"""The port's algorithm-validation ladder against the JAX package's program.

``aide_tpu_torch.experiments.synthetic_aide`` and ``aide_sweep`` against
``experiments/synthetic_aide.py`` and ``experiments/aide_sweep.py``
(imported from ``experiments/`` as ``tests/test_real_ladder_data.py``
imports it), on the CPU at a small size: two-modal FuseUNet at base width 4
and single-modal ``unet4``, 32 px, 6 train cases x 4 slices (2 clean), 3
epochs a stage, ``--device cpu``. The checks and their bars:

- ``build_cfg`` field for field for every stage under every protocol, with
  and without the AIDE overrides;
- ``make_task``'s renders bit for bit under shift, pseudo and transfer, and
  ``clean_gt``'s clone under shift;
- from one JAX-trained pretrain ``.msgpack``, ``apply_pseudo_labels`` in the
  dual and the supervised stage: pseudo-label volumes equal in >= 99.99%
  of voxels, ``pseudo_label_quality`` within 1e-4, the device labels equal
  the host's after the push and the JAX package's device labels;
- ``eval_ckpt_on_domain`` within 1e-4 Dice, ``label_quality`` equal on the
  same labels;
- one AIDE ``run`` of the pseudo protocol (fresh nets) and one of the shift
  protocol (warm-started from the pretrain export) from the JAX trainer's
  initial nets and view parameters, carried in through ``run``'s
  ``prepare`` seam: history metrics within rtol 1e-3 (1e-3 absolute for
  Dice), refresh logs identical, label-quality tracks within 1e-3, the
  engagement verdict equal (floats within 1e-3);
- ``Trainer.on_refresh`` called for the same epochs in the same order as
  the JAX trainer's, after the device labels are synced, and never on a
  supervised run;
- ``main`` at the tiny size: a superset of the JAX summary's keys, the
  arithmetic of ``aide_over_naive`` and ``aide_over_pretrain``, the stage
  exports present; ``aide_sweep.VARIANTS`` equal to the JAX dict and one
  ``--only flagship`` run; the entry points refuse to run without a card
  unless given ``--device cpu``; the new modules import no JAX.

Test-only wrapper: in both modules ``build_cfg`` is wrapped the same way
(``_wrapped_build_cfg``): f32 compute, FuseUNet at base width 4, one device
(the JAX trainer would take the suite's 8 virtual CPU devices), and lr 1e-6
in the naive and AIDE stages, as ``tests/test_torch_epoch.py`` trains (at
1e-4 AMSGrad's first steps follow gradient signs that rounding decides);
the pretrain keeps its lr so that its export predicts decisively.

A case marked ``cuda`` (skipped without a card) launches the TTA warp
kernel at the flagship's 128 px shapes against its plain version.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))

import aide_sweep as JSWEEP  # noqa: E402
import synthetic_aide as JSA  # noqa: E402
from aide_tpu.core import prng as jprng  # noqa: E402
from aide_tpu.data.pipeline import SlicePipeline as JSlicePipeline  # noqa: E402
from aide_tpu.engine import trainer as jtrainer_mod  # noqa: E402
from aide_tpu.ops import tta as jtta  # noqa: E402

from aide_tpu_torch.data.pipeline import SlicePipeline  # noqa: E402
from aide_tpu_torch.evaluation.case_eval import dice3d_np  # noqa: E402
from aide_tpu_torch.experiments import aide_sweep as SWEEP  # noqa: E402
from aide_tpu_torch.experiments import synthetic_aide as SA  # noqa: E402
from aide_tpu_torch.interop.weights import load_variables  # noqa: E402
from aide_tpu_torch.core import trace  # noqa: E402
from aide_tpu_torch.ops import cuda_warp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
SETTINGS = ("NUM_CASES", "CLEAN_CASES", "SLICES_PER_CASE", "MODEL", "IMG_SIZE",
            "NOISY_FRACTION", "NOISE_SHIFT_DIVISOR", "SEED", "STYLE", "PROTOCOL",
            "DOMAIN_SPLIT", "TWO_MODAL", "PACKED", "AIDE_OVERRIDES")
# the flagship's point cut to the test's size
SMALL = dict(NUM_CASES=6, CLEAN_CASES=2, SLICES_PER_CASE=4, MODEL="fuseunet", IMG_SIZE=32,
             SEED=11, STYLE="xhard", PROTOCOL="pseudo", TWO_MODAL=True, AIDE_OVERRIDES=[])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wrapped_build_cfg(build_cfg):
    def wrapped(stage, workdir, epochs, resume=""):
        cfg = build_cfg(stage, workdir, epochs, resume)
        cfg.model.compute_dtype = "float32"
        if cfg.model.name == "fuseunet":
            cfg.model.base_width = 4
        cfg.mesh.num_devices = 1
        if stage in ("naive", "aide"):
            cfg.optim.lr = 1e-6
        return cfg

    return wrapped


@contextlib.contextmanager
def ladder(wrap=True, **settings):
    """Both modules with the same settings (and the wrapped build_cfg),
    restored on exit; the port's stages on the CPU."""
    saved = [(m, {k: getattr(m, k) for k in SETTINGS + ("build_cfg",)}) for m in (JSA, SA)]
    saved.append((SA, {"DEVICE": SA.DEVICE}))
    try:
        for m in (JSA, SA):
            for k, v in settings.items():
                setattr(m, k, list(v) if isinstance(v, list) else v)
            if wrap:
                m.build_cfg = _wrapped_build_cfg(m.build_cfg)
        SA.DEVICE = "cpu"
        yield
    finally:
        for m, values in saved:
            for k, v in values.items():
                setattr(m, k, v)


class _RecordingTrainer(jtrainer_mod.Trainer):
    """The JAX trainer, keeping its nets as construction left them (after a
    warm start) and the epochs its on_refresh hook was called with."""

    made = []

    def __init__(self, *args, **kw):
        self.refresh_calls = []
        super().__init__(*args, **kw)
        self.initial = [jax.tree_util.tree_map(np.asarray, self.state.net_variables(n))
                        for n in range(2)] if self.dual else None
        _RecordingTrainer.made.append(self)

    @property
    def on_refresh(self):
        return self._hook

    @on_refresh.setter
    def on_refresh(self, fn):
        def hook(epoch):
            self.refresh_calls.append(epoch)
            fn(epoch)

        self._hook = None if fn is None else hook


def _jax_run(*args, **kw):
    """synthetic_aide.run of the JAX package, returning its stage dict and
    its trainer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod, "Trainer", _RecordingTrainer)
        result = JSA.run(*args, **kw)
    return result, _RecordingTrainer.made[-1]


def _carry(jtr, record):
    """The ``prepare`` seam: the JAX trainer's initial nets and view
    parameters into the port's trainer, and the port's on_refresh calls
    recorded with whether the device labels equalled the host's."""

    def prepare(tr, stage):
        for n, net in enumerate(tr.state.nets):
            load_variables(net, jtr.initial[n])
        cfg = tr.cfg

        def views(epoch, step, batch):
            key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
            d, h = jtta.sample_view_params(key, cfg.data.num_tta_views, batch,
                                           cfg.data.rotation_degree, cfg.data.hflip_prob)
            return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

        tr.view_params = views
        inner = tr.on_refresh

        def hook(epoch):
            pipe = tr.train_pipe
            record.append((epoch, all(
                np.array_equal(pipe._device_labels[f"target{n}"].numpy(), pipe.labels.get(n))
                for n in (1, 2))))
            inner(epoch)

        tr.on_refresh = hook
        record.append(("trainer", tr))

    return prepare


@pytest.fixture(scope="module")
def pretrain(tmp_path_factory):
    """The JAX pretrain stage's export at the small point."""
    work = tmp_path_factory.mktemp("pretrain")
    with ladder(**SMALL):
        result, _ = _jax_run("pretrain", str(work), EPOCHS)
    assert result["checkpoint"].endswith(".msgpack") and os.path.exists(result["checkpoint"])
    return result["checkpoint"]


def _aide_pair(tmp_path_factory, pretrain, protocol):
    name = f"aide_{protocol}"
    with ladder(**dict(SMALL, PROTOCOL=protocol)):
        resume = pretrain if protocol == "shift" else ""
        jres, jtr = _jax_run("aide", str(tmp_path_factory.mktemp(name + "_jax")), EPOCHS,
                             resume=resume, pseudo_from=pretrain)
        record = []
        tres = SA.run("aide", str(tmp_path_factory.mktemp(name)), EPOCHS, resume=resume,
                      pseudo_from=pretrain, prepare=_carry(jtr, record))
    tr = record.pop(0)[1]
    return dict(jax=jres, port=tres, jtr=jtr, tr=tr, calls=record)


@pytest.fixture(scope="module")
def aide_pseudo(tmp_path_factory, pretrain):
    return _aide_pair(tmp_path_factory, pretrain, "pseudo")


@pytest.fixture(scope="module")
def aide_shift(tmp_path_factory, pretrain):
    return _aide_pair(tmp_path_factory, pretrain, "shift")


# ------------------------------ build_cfg ------------------------------


@pytest.mark.parametrize("protocol", ["shift", "pseudo", "transfer"])
@pytest.mark.parametrize("overrides", [[], ["coteach.warmup_epochs=60", "optim.lr=3e-4"]])
def test_build_cfg_field_for_field(tmp_path, protocol, overrides):
    with ladder(wrap=False, PROTOCOL=protocol, AIDE_OVERRIDES=overrides, PACKED=True,
                MODEL="fuseunet"):
        for stage in ("ceiling", "pretrain", "naive", "aide", "domval_a"):
            for epochs, resume in ((3, ""), (100, "/x/pretrain.pkl")):
                got = SA.build_cfg(stage, str(tmp_path), epochs, resume).to_dict()
                want = JSA.build_cfg(stage, str(tmp_path), epochs, resume).to_dict()
                assert got == want, (stage, epochs)
        aide = SA.build_cfg("aide", str(tmp_path), 100)
    assert aide.coteach.warmup_epochs == (60 if overrides else 20 if protocol != "shift" else 33)
    assert aide.model.packed  # accepted; the port runs the plain network


# ------------------------------ make_task ------------------------------


def _renders(task):
    out = []
    for train in (True, False):
        for spec in task.load_manifest(train=train):
            images, mask = task.decode(spec)
            out.append((spec.case_id, np.asarray(images), np.asarray(mask)))
    return out


@pytest.mark.parametrize("protocol", ["shift", "pseudo", "transfer"])
def test_make_task_renders_bit_for_bit(tmp_path, protocol):
    with ladder(**dict(SMALL, PROTOCOL=protocol, NUM_CASES=4, CLEAN_CASES=1)):
        got = _renders(SA.make_task(str(tmp_path / "t"), "naive", SA.NUM_CASES))
        want = _renders(JSA.make_task(str(tmp_path / "j"), "naive", JSA.NUM_CASES))
    assert len(got) == len(want) == 4 * 4 + 8 * 4
    for (gc, gi, gm), (wc, wi, wm) in zip(got, want):
        assert gc == wc
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_clean_gt_clone_under_shift(tmp_path):
    """Under shift the targets are corrupted; both modules' clones render
    the same clean masks, which differ from the corrupted ones."""
    with ladder(**dict(SMALL, PROTOCOL="shift", NUM_CASES=4, CLEAN_CASES=1)):
        def fake(task, pipeline_cls):
            specs = task.load_manifest(train=True)
            pipe = pipeline_cls(task, specs, 32, 0.0, 1.0, working_labels=False)
            return types.SimpleNamespace(train_pipe=pipe, task=task)

        tr = fake(SA.make_task(str(tmp_path / "t"), "aide", 4), SlicePipeline)
        jtr = fake(JSA.make_task(str(tmp_path / "j"), "aide", 4), JSlicePipeline)
        got, want = SA.clean_gt(tr), JSA.clean_gt(jtr)
    np.testing.assert_array_equal(got, want)
    assert SA.clean_gt(tr) is got  # cached on the trainer
    assert not np.array_equal(got, tr.train_pipe.targets)


# -------------------------- apply_pseudo_labels --------------------------


@pytest.mark.parametrize("stage", ["aide", "naive"])
def test_apply_pseudo_labels_matches(tmp_path, pretrain, stage, capsys):
    with ladder(**SMALL):
        def trainers():
            cfg = SA.build_cfg(stage, str(tmp_path / "t"), EPOCHS)
            task = SA.make_task(str(tmp_path / "t"), stage, SA.NUM_CASES)
            tr = SA.Trainer(cfg, task=task, device="cpu")
            tr.label_cases = set(task.clean_case_ids())
            jcfg = JSA.build_cfg(stage, str(tmp_path / "j"), EPOCHS)
            jtask = JSA.make_task(str(tmp_path / "j"), stage, JSA.NUM_CASES)
            jtr = jtrainer_mod.Trainer(jcfg, task=jtask)
            jtr.label_cases = set(jtask.clean_case_ids())
            return tr, jtr

        tr, jtr = trainers()
        q = SA.apply_pseudo_labels(tr, pretrain)
        line = capsys.readouterr().out.strip().splitlines()[-1]
        jq = JSA.apply_pseudo_labels(jtr, pretrain)
        assert abs(q - jq) <= 1e-4
        assert json.loads(line) == {"pseudo_label_quality": round(q, 4)}
        pipe, jpipe = tr.train_pipe, jtr.train_pipe
        if stage == "aide":
            for n in (1, 2):
                got, want = pipe.labels.get(n), jpipe.labels.get(n)
                assert np.mean(got == want) >= 0.9999, n
                dev = pipe._device_labels[f"target{n}"].numpy()
                np.testing.assert_array_equal(dev, got)
                assert np.mean(dev == np.asarray(jpipe._device_labels[f"target{n}"])) >= 0.9999
            # the labeled cases keep their GT, the others were rewritten
            assert np.mean(pipe.labels.get(1) == pipe.targets) < 1.0
            assert SA.label_quality(tr) == pytest.approx(JSA.label_quality(jtr), abs=1e-4)
        else:
            assert np.mean(pipe.targets == jpipe.targets) >= 0.9999
            np.testing.assert_array_equal(pipe._device_data["target"].numpy(), pipe.targets)
            assert np.mean(pipe.targets == np.asarray(jpipe._device_data["target"])) >= 0.9999


def test_label_quality_equal_on_the_same_labels(tmp_path):
    """label_quality under shift (the clone's clean GT) on labels copied
    from one module's trainer into the other's."""
    with ladder(**dict(SMALL, PROTOCOL="shift", NUM_CASES=4, CLEAN_CASES=1)):
        cfg = SA.build_cfg("aide", str(tmp_path / "t"), EPOCHS)
        task = SA.make_task(str(tmp_path / "t"), "aide", 4)
        tr = SA.Trainer(cfg, task=task, device="cpu")
        tr.label_cases = set(task.clean_case_ids())
        jtask = JSA.make_task(str(tmp_path / "j"), "aide", 4)
        jtr = types.SimpleNamespace(
            train_pipe=JSlicePipeline(jtask, jtask.load_manifest(train=True), 32, 0.0, 1.0,
                                      working_labels=True),
            task=jtask, label_cases=set(jtask.clean_case_ids()))
        rng = np.random.default_rng(5)
        for n in (1, 2):
            labels = (rng.random(tr.train_pipe.labels.get(n).shape) < 0.3).astype(np.uint8)
            tr.train_pipe.labels.get(n)[:] = labels
            jtr.train_pipe.labels.get(n)[:] = labels
        got, want = SA.label_quality(tr), JSA.label_quality(jtr)
    assert got == want and 0.0 < got < 1.0


def test_eval_ckpt_on_domain_matches(tmp_path, pretrain):
    with ladder(**dict(SMALL, PROTOCOL="transfer")):
        got = SA.eval_ckpt_on_domain(pretrain, str(tmp_path / "t"), "a")
        want = JSA.eval_ckpt_on_domain(pretrain, str(tmp_path / "j"), "a")
    assert abs(got - want) <= 1e-4 and 0.0 <= got <= 1.0


# ------------------------------ AIDE runs ------------------------------


def _hold_runs(pair):
    jtr, tr = pair["jtr"], pair["tr"]
    jres, tres = pair["jax"], pair["port"]
    assert tr.refresh_log == jtr.refresh_log and tr.refresh_log
    jh, th = jtr.history, tr.history
    assert len(th) == len(jh) == EPOCHS
    for j, t in zip(jh, th):
        assert set(t) == set(j)
        for key in j:
            if key.startswith("time") or key == "epoch":
                continue
            atol = 1e-3 if "dice" in key else 0.0
            np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=atol,
                                       err_msg=f"epoch {j['epoch']} {key}")
    jt, tt = jres["label_quality_track"], tres["label_quality_track"]
    assert [e["epoch"] for e in tt] == [e["epoch"] for e in jt] and tt
    for a, b in zip(tt, jt):
        assert abs(a["label_quality"] - b["label_quality"]) <= 1e-3
    assert abs(tres["final_label_quality"] - jres["final_label_quality"]) <= 1e-3
    je, te = jres["engagement"], tres["engagement"]
    assert set(te) == set(je)
    for key, v in je.items():
        if isinstance(v, (bool, str)) or v is None:
            assert te[key] == v, key
        else:
            assert abs(te[key] - v) <= 1e-3, key
    for key in ("best_testcase_dice", "final_testcase_dice"):
        assert abs(tres[key] - jres[key]) <= 1e-3, key
    # the JAX stage dict's keys, and the port's additions
    assert set(tres) == set(jres) | {"seconds", "train_steps", "warp_launches",
                                     "graph_replays"}
    assert tres["checkpoint"].endswith("_net1_besttraincasedice.pkl")
    assert os.path.exists(tres["checkpoint"])
    # no kernel on the CPU: the plain warp, never a launch
    assert tres["warp_launches"] == tres["graph_replays"] == 0
    assert tres["train_steps"] == EPOCHS * 3


def test_aide_run_pseudo_matches_jax(aide_pseudo):
    _hold_runs(aide_pseudo)
    assert aide_pseudo["port"]["engagement_probe"] == pytest.approx(
        aide_pseudo["jax"]["engagement_probe"], abs=1e-4)


def test_aide_run_shift_matches_jax(aide_shift):
    """Warm-started from the pretrain export (the JAX trainer's noise
    carried in), scored against the clone's clean GT."""
    _hold_runs(aide_shift)
    # the warm-started run's own bootstrap probe on the labeled cases
    for key, v in aide_shift["jax"]["engagement_probe"].items():
        assert abs(aide_shift["port"]["engagement_probe"][key] - v) <= 1e-3


@pytest.mark.parametrize("protocol", ["pseudo", "shift"])
def test_on_refresh_called_as_the_jax_trainers(request, protocol):
    pair = request.getfixturevalue(f"aide_{protocol}")
    calls = pair["calls"]
    # the refresh epochs by the warmup (2 of 3), each after the device sync
    assert [e for e, _ in calls] == pair["jtr"].refresh_calls == [0, 1]
    assert all(synced for _, synced in calls)
    assert [e + 1 for e, _ in calls] == [t["epoch"] for t in pair["port"]["label_quality_track"]]
    assert [e for e, _ in calls] == [e for e in range(EPOCHS) if pair["tr"]._is_refresh_epoch(e)]


def test_on_refresh_not_called_on_a_supervised_run(tmp_path):
    calls = []

    def prepare(tr, stage):
        assert tr.on_refresh is None and not tr.dual
        tr.on_refresh = calls.append

    with ladder(**dict(SMALL, MODEL="unet4", TWO_MODAL=False)):
        result = SA.run("naive", str(tmp_path), 2, prepare=prepare)
    assert calls == [] and result["warp_launches"] == 0
    assert "label_quality_track" not in result and os.path.exists(result["checkpoint"])


# --------------------------- main and the sweep ---------------------------


def _jax_summary_keys(argv, tmp_path):
    """The keys of the JAX program's summary for ``argv``, from its ``main``
    with each stage's run replaced by a stub (no training)."""
    def stub(stage, workdir, epochs, resume="", pseudo_from=""):
        return {"best_testcase_dice": 0.5, "checkpoint": os.path.join(workdir, stage)}

    with ladder(wrap=False), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSA, "run", stub)
        mp.setattr(JSA, "eval_ckpt_on_domain", lambda *a: 0.5)
        mp.setattr(sys, "argv", ["synthetic_aide.py", *argv, "--workdir", str(tmp_path),
                                 "--out", str(tmp_path / "j.json")])
        JSA.main()
    with open(tmp_path / "j.json") as fh:
        return set(json.load(fh)["summary"])


@pytest.mark.parametrize("protocol", ["pseudo", "transfer"])
def test_main_tiny(tmp_path, protocol, capsys):
    argv = ["--protocol", protocol, "--style", "xhard", "--model", "unet4", "--img-size", "32", "--num-cases", "4",
            "--clean-cases", "2", "--slices-per-case", "4", "--epochs", "2",
            "--pretrain-epochs", "2", "--ceiling", "--packed",
            "--aide-override", "coteach.warmup_epochs=2"]
    want = _jax_summary_keys(argv, tmp_path / "j")
    out = tmp_path / "t.json"
    with ladder(wrap=False):
        assert SA.main([*argv, "--workdir", str(tmp_path / "t"), "--out", str(out),
                        "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    with open(out) as fh:
        saved = json.load(fh)
    summary, runs = saved["summary"], saved["runs"]
    assert lines[-1] == summary
    assert set(summary) == want | {"device_name", "power_limit_w"}
    assert summary["device_name"] == "cpu" and summary["power_limit_w"] is None
    assert summary["aide_over_naive"] == round(
        runs["aide"]["best_testcase_dice"] - runs["naive"]["best_testcase_dice"], 4)
    assert summary["aide_over_pretrain"] == round(
        runs["aide"]["best_testcase_dice"] - runs["pretrain"]["best_testcase_dice"], 4)
    assert summary["ceiling_best_dice"] == runs["ceiling"]["best_testcase_dice"]
    assert sorted(runs) == ["aide", "ceiling", "naive", "pretrain"]
    for stage, r in runs.items():
        assert os.path.exists(r["checkpoint"]), stage
        assert r["warp_launches"] == 0
    assert {"pseudo_label_quality"} <= {k for ln in lines for k in ln}
    if protocol == "transfer":
        assert 0.0 <= runs["pretrain"]["source_domain_dice"] <= 1.0
        assert summary["direction"] == "a:b"
    assert [t["epoch"] for t in runs["aide"]["label_quality_track"]] == [1, 2]


def test_sweep_variants_and_flagship(tmp_path, capsys):
    assert SWEEP.VARIANTS == JSWEEP.VARIANTS
    with ladder(wrap=False):
        assert SA.main(["--protocol", "pseudo", "--model", "unet4", "--img-size", "32",
                        "--num-cases", "4", "--clean-cases", "2", "--slices-per-case", "4",
                        "--epochs", "1", "--pretrain-epochs", "2", "--device", "cpu",
                        "--workdir", str(tmp_path / "pre")]) == 0
    pre = os.path.join(tmp_path, "pre", "ckpt_pretrain", "unet4_temp1.0_r200_besttraincasedice.pkl")
    capsys.readouterr()
    out = tmp_path / "sweep.json"
    with ladder(wrap=False):
        assert SWEEP.main([pre, "--only", "flagship", "--epochs", "2", "--model", "unet4",
                           "--img-size", "32", "--num-cases", "4", "--clean-cases", "2",
                           "--slices-per-case", "4", "--workroot", str(tmp_path / "sw"),
                           "--out", str(out), "--device", "cpu"]) == 0
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"flagship"')]
    with open(out) as fh:
        results = json.load(fh)
    assert list(results) == ["flagship"] and len(printed) == 1
    r = results["flagship"]
    assert r["overrides"] == [] and r["stage"] == "aide" and r["epochs"] == 2
    assert os.path.exists(r["checkpoint"]) and 0.0 <= r["final_label_quality"] <= 1.0


@pytest.mark.parametrize("module", ["synthetic_aide", "aide_sweep"])
def test_entry_points_need_a_card_or_cpu(module):
    """Without --device the programs raise where no card is visible."""
    code = (f"from aide_tpu_torch.experiments.{module} import main\n"
            "import sys\n"
            f"sys.exit(main({['x.pkl'] if module == 'aide_sweep' else []!r}))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "no CUDA device available" in proc.stderr


def test_experiments_import_no_jax_in_a_fresh_process():
    root = os.path.join(REPO, "aide_tpu_torch", "experiments")
    names = sorted(n[:-3] for n in os.listdir(root) if n.endswith(".py"))
    assert {"__init__", "synthetic_aide", "aide_sweep", "seeds"} <= set(names)
    mods = [f"aide_tpu_torch.experiments.{n}".removesuffix(".__init__") for n in names]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'aide_tpu', 'experiments', 'synthetic_aide', "
        "'aide_sweep'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|aide_tpu|experiments|"
                     r"synthetic_aide|aide_sweep)(\.|\s|$)", re.M)
    files = [os.path.join(root, f"{n}.py") for n in names] + [os.path.join(REPO, "chip_smoke.py")]
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}: {m.group(0).strip()}" for m in pat.finditer(fh.read())]
    assert not hits, hits


# ------------------------------ on the card ------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,inverse", [((32, 128, 128, 3), False), ((64, 128, 128, 2), True)])
def test_cuda_kernel_at_the_flagship_shapes(cuda_device, shape, inverse):
    """The flagship AIDE step's launches (two-modal FuseUNet, 128 px, batch
    8, 4 views at +-45 degrees): both modalities' views, then both nets'
    logits, against the plain version."""
    rng = np.random.default_rng(shape[0] + shape[3])
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    d = torch.from_numpy(rng.uniform(-45, 45, shape[0]).astype(np.float32)).to(cuda_device)
    h = torch.from_numpy((rng.random(shape[0]) < 0.5).astype(np.float32)).to(cuda_device)
    f = torch.from_numpy(rng.normal(size=(shape[0], shape[3])).astype(np.float32)).to(cuda_device)
    before = trace.totals()
    got = cuda_warp.warp_rotate_flip(x, d, h, f, inverse=inverse)
    assert trace.delta(before) == {"warp.launches": 1}
    table = cuda_warp.coef_table(d, h, inverse)
    ref = cuda_warp.warp_plain(x, table, cuda_warp.fill_table(f, shape[0], shape[3], cuda_device),
                               inverse)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5


# ------------------------------ seeds ------------------------------


def test_seeds_starts_one_ladder_a_seed(tmp_path, monkeypatch, capsys):
    from aide_tpu_torch.experiments import seeds

    started = []

    class Proc:
        def __init__(self, cmd, stdout, stderr, env):
            started.append((cmd, env.get("CUDA_VISIBLE_DEVICES")))

        def poll(self):
            return 0

    monkeypatch.setattr(seeds.subprocess, "Popen", Proc)
    monkeypatch.setattr(seeds.time, "sleep", lambda s: None)
    assert seeds.main(["--seeds", "11,23", "--outdir", str(tmp_path), "--one-card-each", "--",
                       "--style", "xhard", "--epochs", "2"]) == 0
    assert [env for _, env in started] == ["0", "1"]
    for (cmd, _), seed in zip(started, (11, 23)):
        assert cmd[1:3] == ["-m", "aide_tpu_torch.experiments.synthetic_aide"]
        assert cmd[3:7] == ["--style", "xhard", "--epochs", "2"]
        assert cmd[7:] == ["--seed", str(seed), "--workdir", str(tmp_path / f"work_seed{seed}"),
                           "--out", str(tmp_path / f"seed{seed}.json")]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("seed") for ln in lines[:2]] == [11, 23] and lines[-1]["seeds"] == [11, 23]


def test_seeds_reports_a_failed_seed(tmp_path, capsys):
    from aide_tpu_torch.experiments import seeds

    assert seeds.main(["--seeds", "5", "--outdir", str(tmp_path), "--", "--style", "bogus",
                       "--device", "cpu"]) == 1
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    assert line["seed"] == 5 and line["returncode"] == 2
    with open(line["log"]) as fh:
        assert "invalid choice: 'bogus'" in fh.read()
