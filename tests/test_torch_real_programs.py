"""The port's real-data CHAOS programs against the JAX package's.

``aide_tpu_torch.experiments.chaos_real_1case``, ``chaos_real_ladder`` and
``chaos_real_proposed`` against ``experiments/chaos_real_*.py`` (imported
from ``experiments/`` as ``tests/test_real_ladder_data.py`` imports them),
both reading one ``write_reference_chaos`` tree at 32 px: the JAX programs
through their ``REF_ROOT`` and ``REF_SPLIT``, monkeypatched, the port's
through the same constants or ``--reference``. The checks and their bars:

- the fixture tree: the reference's layout, 30 and 50 slice pairs, the
  absent cases' rows, the bootstrap labels' Dice pinned by the seed;
- the CSVs of ``make_csvs`` and ``make_workdir`` byte for byte, the work
  root's symlinks alike;
- ``build_cfg`` of every stage field for field (the config the JAX
  ``main`` builds inline where it has no ``build_cfg``);
- ``shipped_pseudo_volume`` bit for bit, ``initial_pseudo_quality`` within
  1e-6;
- the ladder's AIDE rung and ``chaos_real_proposed``, 2 epochs each from
  the JAX trainer's initial nets and view parameters carried in through
  ``prepare``: history metrics within rtol 1e-3 (1e-3 absolute for Dice),
  refresh logs identical, the label-quality track and the oracle within
  1e-3, the half-life warning, the probe and the end-of-ramp verdict equal
  (floats within 1e-3);
- the naive rung's targets and device cache after the rewrite, and the AIDE
  rung's seeded labels, with the device cache live and off;
- the port counterparts of ``tests/test_real_ladder_data.py``'s checks:
  the CSVs and the pseudo-labels aligned, the refresh alive, the tempmasks
  outside the reference tree;
- the reference tree unchanged after every run;
- each ``main`` at the tiny size: a superset of the JAX program's keys,
  and the AIDE rung warm-started through ``--resume``; the entry points
  refuse to run without a card unless given ``--device cpu``; the new
  modules import no JAX (nor pandas) in a fresh process.

Test-only wrapper: a ``Trainer`` subclass patched into each package's
trainer module (``_JaxSmall``, ``_PortSmall``) cuts every config the same
way: FuseUNet at base width 4, f32, 32 px, one device (the JAX trainer
would take the suite's 8 virtual CPU devices), lr 1e-6 (as
``tests/test_torch_epoch.py`` trains) and a 2-epoch warmup ramp, so that a
2-epoch run ends the ramp and gives its engagement verdict.

The TTA warp kernel at this path's shapes is held to its plain version on
a card by ``tests/test_torch_warp.py::test_cuda_kernel_at_the_real_programs_shapes``
(a file that runs where JAX is absent).
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))

import chaos_real_1case as J1  # noqa: E402
import chaos_real_ladder as JL  # noqa: E402
import chaos_real_proposed as JP  # noqa: E402
from aide_tpu.core import prng as jprng  # noqa: E402
from aide_tpu.data.pipeline import SlicePipeline as JSlicePipeline  # noqa: E402
from aide_tpu.data.tasks.chaos import ChaosTask as JChaosTask  # noqa: E402
from aide_tpu.engine import trainer as jtrainer_mod  # noqa: E402
from aide_tpu.ops import tta as jtta  # noqa: E402

from aide_tpu_torch.data.fixtures import write_reference_chaos  # noqa: E402
from aide_tpu_torch.data.pipeline import SlicePipeline  # noqa: E402
from aide_tpu_torch.data.tasks.chaos import ChaosTask  # noqa: E402
from aide_tpu_torch.engine import checkpoint as ckpt_mod  # noqa: E402
from aide_tpu_torch.engine import trainer as trainer_mod  # noqa: E402
from aide_tpu_torch.experiments import chaos_real_1case as P1  # noqa: E402
from aide_tpu_torch.experiments import chaos_real_ladder as PL  # noqa: E402
from aide_tpu_torch.experiments import chaos_real_proposed as PP  # noqa: E402
from aide_tpu_torch.experiments import reference  # noqa: E402
from aide_tpu_torch.interop.weights import load_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 2
SIZE = 32
HALF_LIFE = "STRUCTURAL REFRESH CHECK FAILED"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cut(cfg):
    cfg.model.base_width = 4
    cfg.model.compute_dtype = "float32"
    cfg.data.img_size = SIZE
    cfg.mesh.num_devices = 1
    cfg.optim.lr = 1e-6
    cfg.coteach.warmup_epochs = 2


def _fake_history(epochs):
    return [{"epoch": e + 1, "testcase_dice1": 0.5, "testcase_dice2": 0.5,
             "traincase_dice1": 0.5, "traincase_dice2": 0.5} for e in range(epochs)]


class _JaxSmall(jtrainer_mod.Trainer):
    """The JAX trainer on the cut config, keeping the config as the program
    built it, its nets as construction left them, and the epochs its
    on_refresh hook was called with; ``fake`` skips training."""

    made = []
    fake = False

    def __init__(self, cfg, *args, **kw):
        self.built = cfg.to_dict()
        _cut(cfg)
        self.refresh_calls = []
        self._hook = None
        super().__init__(cfg, *args, **kw)
        self.initial = [jax.tree_util.tree_map(np.asarray, self.state.net_variables(n))
                        for n in range(2)] if self.dual else None
        _JaxSmall.made.append(self)

    @property
    def on_refresh(self):
        return self._hook

    @on_refresh.setter
    def on_refresh(self, fn):
        def hook(epoch):
            self.refresh_calls.append(epoch)
            fn(epoch)

        self._hook = None if fn is None else hook

    def run(self, num_epochs=None):
        if _JaxSmall.fake:
            return _fake_history(num_epochs)
        return super().run(num_epochs)


class _PortSmall(trainer_mod.Trainer):
    """The port's trainer on the cut config; ``device_cache`` is set on it,
    ``fake`` skips training."""

    made = []
    fake = False
    device_cache = "auto"

    def __init__(self, cfg, *args, **kw):
        self.built = cfg.to_dict()
        _cut(cfg)
        cfg.data.device_cache = _PortSmall.device_cache
        super().__init__(cfg, *args, **kw)
        self.initial = [{k: v.detach().clone() for k, v in net.state_dict().items()}
                        for net in self.state.nets]
        _PortSmall.made.append(self)

    def run(self, num_epochs=None):
        if _PortSmall.fake:
            return _fake_history(num_epochs)
        return super().run(num_epochs)


def _digest(path):
    """Every entry under ``path``: its relative name, kind, size and bytes."""
    h = hashlib.sha1()
    for top, dirs, files in sorted(os.walk(path)):
        dirs.sort()
        for name in sorted(dirs + files):
            full = os.path.join(top, name)
            h.update(os.path.relpath(full, path).encode())
            if os.path.islink(full):
                h.update(b"link" + os.readlink(full).encode())
            elif os.path.isfile(full):
                with open(full, "rb") as fh:
                    h.update(fh.read())
    return h.hexdigest()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("reference")
    tree = write_reference_chaos(str(base), size=SIZE, seed=0)
    return dict(tree, dir=str(base), digest=_digest(str(base)))


@contextlib.contextmanager
def programs(ref, fake=False, device_cache="auto"):
    """Both packages' programs on the fixture tree and the cut trainers;
    the port's on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        for m in (J1, JL, JP, P1, PL, PP):
            mp.setattr(m, "REF_ROOT", ref["root"])
            mp.setattr(m, "REF_SPLIT", ref["split"])
        for m in (P1, PL, PP):
            mp.setattr(m, "DEVICE", "cpu")
        mp.setattr(jtrainer_mod, "Trainer", _JaxSmall)
        mp.setattr(trainer_mod, "Trainer", _PortSmall)
        mp.setattr(_JaxSmall, "fake", fake)
        mp.setattr(_PortSmall, "fake", fake)
        mp.setattr(_PortSmall, "device_cache", device_cache)
        yield


def _carry(jtr, record):
    """The ``prepare`` seam: the JAX trainer's initial nets and view
    parameters into the port's trainer."""

    def prepare(tr, *stage):
        for n, net in enumerate(tr.state.nets):
            load_variables(net, jtr.initial[n])
        cfg = tr.cfg

        def views(epoch, step, batch):
            key = jprng.step_key(jprng.epoch_key(jtr.root_key, epoch), step)
            d, h = jtta.sample_view_params(key, cfg.data.num_tta_views, batch,
                                           cfg.data.rotation_degree, cfg.data.hflip_prob)
            return torch.from_numpy(np.array(d)), torch.from_numpy(np.array(h))

        tr.view_params = views
        record.append(tr)

    return prepare


def _log_text(trainer):
    path = os.path.join(trainer.cfg.history_dir, f"{trainer.cfg.experiment_name}.log")
    with open(path) as fh:
        return fh.read()


@pytest.fixture(scope="module")
def aide_pair(tmp_path_factory, ref):
    """The ladder's AIDE rung, 2 epochs in each package from the JAX
    trainer's initial nets."""
    with programs(ref):
        jwork = str(tmp_path_factory.mktemp("aide_jax"))
        jres = JL.run_stage("aide", jwork, EPOCHS)
        jtr = _JaxSmall.made[-1]
        record = []
        work = str(tmp_path_factory.mktemp("aide"))
        tres = PL.run_stage("aide", work, EPOCHS, prepare=_carry(jtr, record))
    return dict(jax=jres, port=tres, jtr=jtr, tr=record[0], work=work)


@pytest.fixture(scope="module")
def proposed_pair(tmp_path_factory, ref):
    """chaos_real_proposed, 2 epochs: the JAX program's ``main``, then the
    port's ``run`` from the JAX trainer's initial nets."""
    jwork = tmp_path_factory.mktemp("proposed_jax")
    with programs(ref), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["chaos_real_proposed.py", "--epochs", str(EPOCHS),
                                 "--workdir", str(jwork), "--out", str(jwork / "out.json")])
        assert JP.main() == 0
        jtr = _JaxSmall.made[-1]
        record = []
        work = str(tmp_path_factory.mktemp("proposed"))
        tres = PP.run(work, EPOCHS, prepare=_carry(jtr, record))
    with open(jwork / "out.json") as fh:
        jres = json.load(fh)
    return dict(jax=jres, port=tres, jtr=jtr, tr=record[0], work=work, jwork=str(jwork))


# ------------------------------ the fixture ------------------------------


def test_reference_tree_layout(ref, tmp_path):
    root, split = ref["root"], ref["split"]
    assert (root, split) == reference.chaos_paths(ref["dir"])
    for case, slices in (("37", 30), ("10", 50)):
        series = os.path.join(root, case, "T1DUAL")
        inphase = sorted(os.listdir(os.path.join(series, "DICOM_anon", "InPhase")))
        outphase = sorted(os.listdir(os.path.join(series, "DICOM_anon", "OutPhase")))
        ground = sorted(os.listdir(os.path.join(series, "Ground")))
        assert len(inphase) == len(outphase) == len(ground) == slices
        assert [n[:-4] for n in ground] == [n[:-4] for n in inphase]
    pseudo = sorted(os.listdir(os.path.join(root, PL.PSEUDO_DIR, "10")))
    assert pseudo == sorted(os.listdir(os.path.join(root, "10", "T1DUAL", "Ground")))
    assert sorted(os.listdir(root)) == ["10", "37", "generated_masks"]
    for rel, n_rows, cases in (
        ("splitimages_cleanlabel/train_data_1cases.csv", 30, {"37"}),
        ("splitimages_cleanlabel/val_data_10cases.csv", 50 + 9 * 4, None),
        ("splitimages_pseudolabels_1pretrain/train_data_30cases.csv", 30 + 29 * 4, None),
    ):
        header, rows = reference.read_table(os.path.join(split, rel))
        assert header == ["Inphase", "Outphase", "Mask"] and len(rows) == n_rows, rel
        listed = {r[0].split("/")[0] for r in rows}
        assert cases is None or listed == cases
        assert len(listed) == {30: 1, 86: 10, 146: 30}[n_rows]
        for r in rows:
            present = r[0].split("/")[0] in ("10", "37")
            assert all(os.path.exists(os.path.join(root, p)) == present for p in r), r
    # the pseudo-labels are the 30-case CSV's other cases' masks' folder
    _, rows30 = reference.read_table(os.path.join(split, rel))
    assert all(r[2].startswith(PL.PSEUDO_DIR + "/") for r in rows30 if not r[0].startswith("37/"))
    # the bootstrap labels' Dice, pinned by the seed
    assert round(ref["pseudo_dice"], 4) == 0.5773
    assert round(write_reference_chaos(str(tmp_path), size=256)["pseudo_dice"], 4) == 0.5328
    assert ref["digest"] == _digest(ref["dir"])


# ------------------------------ the CSVs ------------------------------


def _bytes(paths):
    out = []
    for p in paths:
        with open(p, "rb") as fh:
            out.append(fh.read())
    return out


@pytest.mark.parametrize("program", ["1case", "ladder"])
def test_make_csvs_byte_for_byte(ref, tmp_path, program):
    jmod, pmod = {"1case": (J1, P1), "ladder": (JL, PL)}[program]
    with programs(ref):
        want = jmod.make_csvs(str(tmp_path / "j"))
        got = pmod.make_csvs(str(tmp_path / "t"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert _bytes(got) == _bytes(want)
    assert all(b"\r" not in b for b in _bytes(got))
    # the reference's own CSV stays where it is
    if program == "1case":
        assert got[0] == want[0] and got[0].startswith(ref["split"])


def test_make_workdir_byte_for_byte(ref, tmp_path):
    with programs(ref):
        want = JP.make_workdir(str(tmp_path / "j"))
        got = PP.make_workdir(str(tmp_path / "t"))
        # a second call keeps the links and rewrites the same files
        again = PP.make_workdir(str(tmp_path / "t"))
    assert got == again
    assert [os.path.basename(p) for p in got[1:]] == [os.path.basename(p) for p in want[1:]]
    assert _bytes(got[1:]) == _bytes(want[1:])
    for name in ("10", "37", "generated_masks"):
        assert os.readlink(os.path.join(got[0], name)) == os.readlink(os.path.join(want[0], name))
        assert os.readlink(os.path.join(got[0], name)) == os.path.join(ref["root"], name)
    header, rows = reference.read_table(got[1])
    assert len(rows) == 80 and [r[0].split("/")[0] for r in rows] == ["37"] * 30 + ["10"] * 50
    assert all(r[2].startswith(PP.PSEUDO_REL + "/10/") for r in rows[30:])


@pytest.mark.parametrize("cut", ["37", "10"])
def test_short_manifests_refused(ref, tmp_path, cut):
    """A manifest that lists fewer slice pairs of a shipped case than the
    programs expect raises before anything is trained, as the JAX
    programs' asserts stop them."""
    split = tmp_path / "split"
    for rel in ("splitimages_cleanlabel/val_data_10cases.csv",
                "splitimages_pseudolabels_1pretrain/train_data_30cases.csv",
                "splitimages_cleanlabel/train_data_1cases.csv"):
        header, rows = reference.read_table(os.path.join(ref["split"], rel))
        os.makedirs(split / os.path.dirname(rel), exist_ok=True)
        kept = [r for r in rows if not r[0].startswith(f"{cut}/")] + [
            r for r in rows if r[0].startswith(f"{cut}/")][:-1]
        reference.write_table(str(split / rel), header, kept)
    with programs(ref), pytest.MonkeyPatch.context() as mp:
        mp.setattr(PP, "REF_SPLIT", str(split))
        with pytest.raises(ValueError, match=f"rows of case {cut}, expected {30 if cut == '37' else 50}"):
            PP.make_workdir(str(tmp_path / "w"))
        with pytest.raises(AssertionError):
            mp.setattr(JP, "REF_SPLIT", str(split))
            JP.make_workdir(str(tmp_path / "j"))


# ------------------------------ build_cfg ------------------------------


@pytest.mark.parametrize("stage", ["naive", "aide"])
@pytest.mark.parametrize("kw", [{}, {"resume": "/x/pre.pkl"},
                                {"img_size": 64, "base_width": 4, "batch": 2}])
def test_ladder_build_cfg_field_for_field(ref, tmp_path, stage, kw):
    with programs(ref):
        for epochs in (3, 100):
            got = PL.build_cfg(stage, str(tmp_path), epochs, **kw).to_dict()
            want = JL.build_cfg(stage, str(tmp_path), epochs, **kw).to_dict()
            assert got == want, epochs
    if stage == "aide":
        assert got["resume_file"] == kw.get("resume", "")
        assert got["data"]["tempmask_folder"] == os.path.join(str(tmp_path), "tempmask_aide")


def test_1case_main_and_build_cfg(ref, tmp_path, capsys):
    """The JAX ``main`` (training skipped) builds the config the port's
    ``build_cfg`` builds, and prints a subset of the keys the port's
    ``main`` prints at the tiny size."""
    with programs(ref, fake=True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["chaos_real_1case.py", "--epochs", "7", "--workdir",
                                 str(tmp_path / "j"), "--out", str(tmp_path / "j.json")])
        assert J1.main() == 0
        jtr = _JaxSmall.made[-1]
        want_cfg = P1.build_cfg(str(tmp_path / "j"), 7).to_dict()
    assert jtr.built == want_cfg
    with open(tmp_path / "j.json") as fh:
        jkeys = set(json.load(fh))
    capsys.readouterr()
    out = tmp_path / "t.json"
    with programs(ref):
        assert P1.main(["--epochs", "1", "--reference", ref["dir"], "--workdir",
                        str(tmp_path / "t"), "--out", str(out), "--device", "cpu"]) == 0
        built = P1.build_cfg(str(tmp_path / "t"), 1).to_dict()
    assert _PortSmall.made[-1].built == built
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as fh:
        saved = json.load(fh)
    assert line == saved
    assert set(saved) == jkeys | {"seconds", "train_steps", "warp_launches", "graph_replays",
                                  "checkpoint", "device_name", "power_limit_w"}
    assert saved["train_slices"] == 30 and saved["val_slices"] == 50
    assert saved["train_steps"] == 7 and saved["warp_launches"] == saved["graph_replays"] == 0
    assert saved["device_name"] == "cpu" and os.path.exists(saved["checkpoint"])
    assert ref["digest"] == _digest(ref["dir"])


def test_proposed_build_cfg_field_for_field(ref, proposed_pair):
    """The config the JAX ``main`` built, and the one the port's ``run``
    trained with, are ``build_cfg``'s of their work directories."""
    with programs(ref):
        want = PP.build_cfg(proposed_pair["jwork"], EPOCHS).to_dict()
        got = PP.build_cfg(proposed_pair["work"], EPOCHS).to_dict()
    assert proposed_pair["jtr"].built == want
    assert proposed_pair["tr"].built == got


# ------------------------ the shipped pseudo-labels ------------------------


def test_shipped_pseudo_volume_bit_for_bit(ref, tmp_path):
    with programs(ref):
        train_csv = PL.make_csvs(str(tmp_path))[0]
        pipes = []
        for task_cls, pipe_cls in ((ChaosTask, SlicePipeline), (JChaosTask, JSlicePipeline)):
            task = task_cls(root=ref["root"])
            pipes.append(pipe_cls(task, task.load_manifest(train_csv, train=True), SIZE,
                                  working_labels=False))
        got = PL.shipped_pseudo_volume(pipes[0], "10")
        want = JL.shipped_pseudo_volume(pipes[1], "10")
    assert got.dtype == want.dtype and got.shape == (50, SIZE, SIZE)
    np.testing.assert_array_equal(got, want)
    idx = pipes[0].case_indices("10")
    assert idx == pipes[1].case_indices("10") == list(range(30, 80))
    q, jq = PL.dice(got, pipes[0].targets[idx]), JL.dice(want, pipes[1].targets[idx])
    assert abs(q - jq) <= 1e-6 and q == round(ref["pseudo_dice"], 4)


# ------------------------------ the AIDE rung ------------------------------


def _hold_history(jtr, tr):
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


def _hold_engagement(te, je):
    assert set(te) == set(je)
    for key, v in je.items():
        if isinstance(v, (bool, str)) or v is None:
            assert te[key] == v, key
        else:
            assert abs(te[key] - v) <= 1e-3, key


def _hold_guardrail(jtr, tr):
    """The half-life warning at the first refresh and the end-of-ramp
    verdict, alike in both packages."""
    assert tr._structural_warned and jtr._structural_warned
    assert HALF_LIFE in _log_text(tr) and HALF_LIFE in _log_text(jtr)
    _hold_engagement(tr.engagement, jtr.engagement)
    assert tr.engagement["structural_ok"] is False and tr.engagement["engaged"] is False


def test_aide_rung_matches_jax(aide_pair, ref):
    jres, tres, jtr, tr = aide_pair["jax"], aide_pair["port"], aide_pair["jtr"], aide_pair["tr"]
    _hold_history(jtr, tr)
    _hold_guardrail(jtr, tr)
    jt, tt = jres["label_quality_track"], tres["label_quality_track"]
    assert [e["epoch"] for e in tt] == [e["epoch"] for e in jt] == [1, 2]
    for a, b in zip(tt, jt):
        assert abs(a["label_quality"] - b["label_quality"]) <= 1e-3
    assert abs(tres["initial_pseudo_quality"] - jres["initial_pseudo_quality"]) <= 1e-6
    _hold_engagement(tres["engagement"], jres["engagement"])
    # the probe set from outside: equal, and the trainer measured none
    assert tres["engagement_probe"] == jres["engagement_probe"] == {
        "bootstrap_skill1": tres["initial_pseudo_quality"],
        "bootstrap_skill2": tres["initial_pseudo_quality"]}
    assert "bootstrap skill probe" not in _log_text(tr)
    for key in ("best_case10_dice", "final_case10_dice"):
        assert abs(tres[key] - jres[key]) <= 1e-3, key
    assert set(tres) == set(jres) | {"seconds", "train_steps", "warp_launches", "graph_replays",
                                     "checkpoint"}
    assert tres["warm_start"] is False and tres["train_steps"] == EPOCHS * 20
    # no kernel on the CPU: the plain warp, and no graph
    assert tres["warp_launches"] == tres["graph_replays"] == 0
    assert tres["checkpoint"].endswith("_net1_besttraincasedice.pkl")
    assert os.path.exists(tres["checkpoint"])
    # k = 2 of the 2 cases selects both a net and epoch; case 37 is exempt
    assert all(set(sel) == {"10", "37"} and done == ("10",) for *_, sel, done in tr.refresh_log)
    assert ref["digest"] == _digest(ref["dir"])


def test_aide_rung_tempmasks_outside_the_reference(aide_pair, ref):
    """The real-DICOM smoke of test_real_ladder_data.py on the fixture: the
    refresh mirrored case 10's working labels in the reference's tempmask
    convention under the work directory, and the seeding wrote them there
    before the first step."""
    tres, tr = aide_pair["port"], aide_pair["tr"]
    assert tres["initial_pseudo_quality"] > 0.3
    assert 0.0 <= tres["best_case10_dice"] <= 1.0
    temp = os.path.join(aide_pair["work"], "tempmask_aide")
    assert tr.task.tempmask_path(tr.train_pipe.specs[30], 1).startswith(temp + os.sep)
    names = sorted(os.listdir(os.path.join(temp, "10")))
    assert len(names) == 100 and all(n.endswith(("_net1.png", "_net2.png")) for n in names)
    assert not os.path.exists(os.path.join(temp, "37"))
    for n in (1, 2):
        got = np.stack([tr.task.read_tempmask(tr.train_pipe.specs[i], n) for i in range(30, 80)])
        np.testing.assert_array_equal(got, tr.train_pipe.labels.get(n)[30:80])
    assert ref["digest"] == _digest(ref["dir"])


@pytest.mark.parametrize("device_cache", ["auto", "off"])
def test_seeding_and_naive_rewrite(ref, tmp_path, device_cache):
    """Before the first step: the AIDE rung's working labels hold the shipped
    pseudo-labels for case 10 and the ground truth for case 37, on the host
    and in the device copy; the naive rung's targets hold them, re-uploaded
    whole, as the JAX package's do."""
    seen = {}

    def prepare(tr, stage):
        pipe = tr.train_pipe
        seen[stage] = dict(
            targets=pipe.targets.copy(),
            labels=[pipe.labels.get(n).copy() for n in (1, 2)] if pipe.labels else None,
            device=None if pipe._device_data is None else {
                k: v.numpy().copy() for k, v in {**pipe._device_data,
                                                 **(pipe._device_labels or {})}.items()},
            dirty=None if pipe.labels is None else [list(d) for d in pipe.labels.dirty])

    uploads = []
    to_device = SlicePipeline.to_device

    def spy(pipe, device):
        uploads.append((pipe, pipe.targets.copy()))
        to_device(pipe, device)

    with programs(ref, fake=True, device_cache=device_cache), pytest.MonkeyPatch.context() as mp:
        mp.setattr(SlicePipeline, "to_device", spy)
        for stage in ("aide", "naive"):
            PL.run_stage(stage, str(tmp_path / "t"), 1, prepare=prepare)
        pseudo = PL.shipped_pseudo_volume(_PortSmall.made[-1].train_pipe, "10")
        JL.run_stage("naive", str(tmp_path / "j"), 1)
        jpipe = _JaxSmall.made[-1].train_pipe
    gt = seen["aide"]["targets"]
    want = gt.copy()
    want[30:80] = pseudo
    for n in (1, 2):
        np.testing.assert_array_equal(seen["aide"]["labels"][n - 1], want)
    assert seen["aide"]["dirty"] == [[], []]
    np.testing.assert_array_equal(seen["naive"]["targets"], want)
    np.testing.assert_array_equal(seen["naive"]["targets"], np.asarray(jpipe.targets))
    # the naive rung's train pipe re-uploads its rewritten targets where its
    # cache is live (on the CPU the device copy shares the host's memory,
    # so only the upload itself shows it)
    naive_pipe = _PortSmall.made[-1].train_pipe
    again = [t for p, t in uploads if p is naive_pipe]
    if device_cache == "off":
        assert seen["aide"]["device"] is None and seen["naive"]["device"] is None
        assert uploads == []
    else:
        assert len(again) == 2 and not np.array_equal(again[0], want)
        np.testing.assert_array_equal(again[1], want)
        for n in (1, 2):
            np.testing.assert_array_equal(seen["aide"]["device"][f"target{n}"], want)
        np.testing.assert_array_equal(seen["aide"]["device"]["target"], gt)
        np.testing.assert_array_equal(seen["naive"]["device"]["target"], want)
        np.testing.assert_array_equal(np.asarray(jpipe._device_data["target"]), want)
    assert ref["digest"] == _digest(ref["dir"])


# --------------------------- chaos_real_proposed ---------------------------


def test_proposed_matches_jax(proposed_pair, ref):
    jres, tres, jtr, tr = (proposed_pair[k] for k in ("jax", "port", "jtr", "tr"))
    _hold_history(jtr, tr)
    _hold_guardrail(jtr, tr)
    assert tr.engagement_probe is None and jtr.engagement_probe is None
    assert [r["epoch"] for r in tres["label_oracle"]] == [r["epoch"] for r in jres["label_oracle"]]
    assert jtr.refresh_calls == [0, 1] and tres["label_oracle"]
    for a, b in zip(tres["label_oracle"], jres["label_oracle"]):
        for key in ("label_dice1", "label_dice2"):
            assert abs(a[key] - b[key]) <= 1e-3, key
    saved = json.loads(json.dumps(tres))  # the port's --out file
    for key in ("bootstrap_label_dice_case10", "label_oracle_peak"):
        assert abs(saved[key] - jres[key]) <= 1e-3, key
    for key in ("final_case10_dice", "best_case10_dice", "at_checkpoint_gate"):
        assert set(saved[key]) == set(jres[key]) == {"1", "2"}
        for n in ("1", "2"):
            assert abs(saved[key][n] - jres[key][n]) <= 1e-3, (key, n)
    assert saved["gate_epoch"] == jres["gate_epoch"]
    assert saved["bootstrap_label_dice_case10"] == round(ref["pseudo_dice"], 4)
    assert set(saved) == set(jres) | {"seconds", "train_steps", "warp_launches", "graph_replays",
                                      "checkpoint", "device_name", "power_limit_w"}
    assert saved["train_slices"] == 80 and saved["train_steps"] == EPOCHS * 20
    assert saved["warp_launches"] == saved["graph_replays"] == 0
    assert os.path.exists(saved["checkpoint"])
    # the tempmasks lie in a folder of the work root, not in a linked case
    temp = os.path.join(proposed_pair["work"], "root", "tempmasks_real_proposed")
    assert os.path.isdir(temp) and not os.path.islink(temp)
    assert ref["digest"] == _digest(ref["dir"])


def test_proposed_main_tiny(ref, tmp_path, capsys, proposed_pair):
    out = tmp_path / "t.json"
    with programs(ref):
        assert PP.main(["--epochs", "1", "--reference", ref["dir"], "--workdir",
                        str(tmp_path / "t"), "--out", str(out), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("# label oracle {'epoch': 1, ")
    with open(out) as fh:
        saved = json.load(fh)
    summary = json.loads(lines[-1])
    assert summary == {k: v for k, v in saved.items() if k not in ("label_oracle", "history")}
    assert set(saved) == set(proposed_pair["jax"]) | {
        "seconds", "train_steps", "warp_launches", "graph_replays", "checkpoint", "device_name",
        "power_limit_w"}
    assert len(saved["history"]) == 1 and len(saved["label_oracle"]) == 1
    assert ref["digest"] == _digest(ref["dir"])


# ------------------------------ the ladder's main ------------------------------


def test_ladder_main_tiny_and_warm_start(ref, tmp_path, capsys, aide_pair):
    """The JAX ``main``'s keys (its rungs stubbed), the JAX naive rung's
    (training skipped) and the AIDE rung's against the port's ``main`` at
    the tiny size; then ``--stage aide --resume`` from the 1-case export."""
    with programs(ref), pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "run_stage", lambda stage, *a, **kw: {"best_case10_dice": 0.5})
        mp.setattr(sys, "argv", ["chaos_real_ladder.py", "--workdir", str(tmp_path / "j"),
                                 "--out", str(tmp_path / "j.json")])
        assert JL.main() == 0
    with open(tmp_path / "j.json") as fh:
        jtop = set(json.load(fh))
    with programs(ref, fake=True):
        jnaive = JL.run_stage("naive", str(tmp_path / "jn"), 1)
    capsys.readouterr()
    out = tmp_path / "t.json"
    with programs(ref):
        assert PL.main(["--epochs", "1", "--reference", ref["dir"], "--workdir",
                        str(tmp_path / "t"), "--out", str(out), "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    with open(out) as fh:
        saved = json.load(fh)
    assert set(saved) == jtop | {"device_name", "power_limit_w"}
    assert lines[-1] == {k: v for k, v in saved.items() if k != "golden"}
    assert [ln for ln in lines if "initial_pseudo_quality" in ln and len(ln) == 2] == [
        {"stage": s, "initial_pseudo_quality": saved[s]["initial_pseudo_quality"]}
        for s in ("naive", "aide")]
    assert set(saved["naive"]) == set(jnaive) | {"seconds", "train_steps", "warp_launches",
                                                 "graph_replays", "checkpoint"}
    assert set(saved["aide"]) == set(aide_pair["jax"]) - {"engagement"} | {
        "seconds", "train_steps", "warp_launches", "graph_replays", "checkpoint"}
    assert saved["aide_over_naive"] == round(
        saved["aide"]["best_case10_dice"] - saved["naive"]["best_case10_dice"], 4)
    assert [t["epoch"] for t in saved["aide"]["label_quality_track"]] == [1]
    for stage in ("naive", "aide"):
        assert os.path.exists(saved[stage]["checkpoint"])
        assert saved[stage]["warp_launches"] == saved[stage]["graph_replays"] == 0
    # the AIDE rung warm-started from the 1-case program's export
    one = tmp_path / "one.json"
    with programs(ref):
        assert P1.main(["--epochs", "1", "--reference", ref["dir"], "--workdir",
                        str(tmp_path / "one"), "--out", str(one), "--device", "cpu"]) == 0
        with open(one) as fh:
            export = json.load(fh)["checkpoint"]
        assert PL.main(["--stage", "aide", "--epochs", "1", "--resume", export, "--reference",
                        ref["dir"], "--workdir", str(tmp_path / "warm"), "--out",
                        str(tmp_path / "warm.json"), "--device", "cpu"]) == 0
        warm = _PortSmall.made[-1]
    with open(tmp_path / "warm.json") as fh:
        saved = json.load(fh)
    assert saved["aide"]["warm_start"] is True and "naive" not in saved
    assert warm.cfg.resume_file == export
    # both nets start at the export plus the symmetry-breaking noise
    weights = ckpt_mod.load_net(export)
    for sd in warm.initial:
        gaps = [float((sd[k] - v).abs().max()) for k, v in weights.items()
                if v.is_floating_point() and k in sd]
        assert gaps and 0.0 < max(gaps) <= 10 * warm.cfg.coteach.warm_start_noise
    assert ref["digest"] == _digest(ref["dir"])


# ---------------------- test_real_ladder_data.py's contract ----------------------


def test_csvs_and_pseudo_alignment(ref, tmp_path):
    with programs(ref):
        train_csv, val_csv, tc, vc, lc = PL.make_csvs(str(tmp_path))
    header, rows = reference.read_table(train_csv)
    assert sorted({r[0].split("/")[0] for r in rows}) == ["10", "37"]
    for r in reference.require_rows(train_csv, header, rows, "10", count=50):
        p = os.path.join(ref["root"], PL.PSEUDO_DIR, "10", os.path.basename(r[2]))
        assert os.path.exists(p), p
    assert ChaosTask.load_case_list(lc) == ["37"]


def test_aide_cfg_refresh_alive(ref, tmp_path):
    with programs(ref):
        cfg = PL.build_cfg("aide", str(tmp_path), 4)
        naive = PL.build_cfg("naive", str(tmp_path), 4)
    # int(update_percent * 2 train cases) must be >= 1 or refresh never runs
    assert int(cfg.coteach.update_percent * 2) >= 1
    # the disk mirror must stay out of the read-only reference tree
    assert os.path.isabs(cfg.data.tempmask_folder)
    assert not cfg.data.tempmask_folder.startswith(ref["dir"])
    assert cfg.data.variant == "proposed" and naive.data.variant == "comparison"
    task = ChaosTask(root=cfg.data.root, tempmask_folder=cfg.data.tempmask_folder)
    spec = task.load_manifest(cfg.data.train_csv)[0]
    assert task.tempmask_path(spec, 1).startswith(cfg.data.tempmask_folder + os.sep)


# --------------------------- entry points, imports ---------------------------


@pytest.mark.parametrize("module", ["chaos_real_1case", "chaos_real_ladder",
                                    "chaos_real_proposed"])
def test_entry_points_need_a_card_or_cpu(module, tmp_path):
    """Without --device the programs raise where no card is visible, before
    they read or write anything."""
    code = (f"from aide_tpu_torch.experiments.{module} import main\n"
            "import sys\n"
            f"sys.exit(main(['--workdir', {str(tmp_path / 'w')!r}]))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "no CUDA device available" in proc.stderr
    assert not os.path.exists(tmp_path / "w")


def test_real_programs_import_no_jax_in_a_fresh_process():
    mods = ["aide_tpu_torch.data.fixtures", "aide_tpu_torch.experiments.reference",
            "aide_tpu_torch.experiments.chaos_real_1case",
            "aide_tpu_torch.experiments.chaos_real_ladder",
            "aide_tpu_torch.experiments.chaos_real_proposed"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'aide_tpu', 'experiments', 'pandas', "
        "'chaos_real_1case', 'chaos_real_ladder', 'chaos_real_proposed'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|aide_tpu|experiments|pandas|"
                     r"chaos_real_\w+)(\.|\s|$)", re.M)
    hits = []
    for m in mods + ["chip_smoke"]:
        path = os.path.join(REPO, *m.split(".")) + ".py"
        with open(path) as fh:
            hits += [f"{path}: {x.group(0).strip()}" for x in pat.finditer(fh.read())]
    assert not hits, hits
