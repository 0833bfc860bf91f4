"""The port's space axis through the trainer on gloo CPU ranks: two epochs
of ``Trainer.run`` against the JAX ``Trainer`` on one device, and the
trainer's sizing of the axis.

The ranks run ``aide_tpu_torch.core.rank_checks`` programs spawned through
``mesh.launch`` (so they import neither JAX nor this file), one torch
thread each.

- two epochs of the dual co-teaching ``Trainer.run`` (single-modal
  ``unet2``, 32 px, batch 8, 2 views, refresh, case evaluation, the
  checkpoint gate) at space 2 (2 ranks) and net 2 x space 2 (4 ranks),
  from the JAX trainer's weights and view parameters, against the JAX
  ``Trainer`` on one device (the JAX package's space axis is layout only,
  so one device is its reference): the bars of tests/test_mesh_axes.py
  (dice within 0.08 at epoch 1, losses within rtol 3e-2 and atol 2e-3 at
  epoch 1 and 2e-2 at epoch 2, the other keys equal, working labels under
  2% apart), every rank with the same history and labels, the ranks of a
  net with the same parameters, the files written by rank 0 alone, and
  its ``_last_full`` resumed by a one-process trainer holding the ranks'
  nets. At 32 px the UNet's deepest level keeps one row a rank (16 px,
  the JAX test's size, would leave half a row, and the port would turn
  the axis off);
- the sizing: a space axis that does not divide img_size, or that leaves
  a level of the model too few rows for its pools or its widest (dilated)
  halo, is turned off with a warning, the ranks then running as replicas;
  a live axis logs how the TTA warps run, and an explicit 'gather' warp
  gets the JAX trainer's warning.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from aide_tpu.core import prng as jprng
from aide_tpu.core.config import ModelConfig as JModelConfig, TrainConfig as JTrainConfig
from aide_tpu.data.tasks.synthetic import SyntheticTask as JSyntheticTask
from aide_tpu.engine.trainer import Trainer as JTrainer
from aide_tpu.ops import tta as jtta

from aide_tpu_torch.core import mesh
from aide_tpu_torch.core.config import TrainConfig
from aide_tpu_torch.core.rank_checks import train_job, unit_checks
from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
from aide_tpu_torch.engine import checkpoint as ckpt
from aide_tpu_torch.engine import trainer as ttrainer
from aide_tpu_torch.interop.weights import variables_to_state_dict


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the test processes run side by
    side on the host's cores, and at these sizes torch's thread pool spends
    more time waiting for its threads than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


S, V, B, EPOCHS, STEPS = 32, 2, 8, 2, 2
LAYOUTS = {"space 2": (2, (("space", 2),)), "net 2 x space 2": (4, (("net", 2), ("space", 2)))}
TASK_ARGS = dict(
    tempmask_folder="tempmasks", two_modal=False, num_cases=4, slices_per_case=5,
    size=S, noisy_fraction=0.5, clean_cases=1, num_test_cases=1,
    test_case_offset=100, seed=3,
)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The JAX trainer on one device and the port's job at each layout
    through ``mesh.launch``, from the same weights and view parameters; the
    port's jobs run while the JAX one does."""
    tmp = tmp_path_factory.mktemp("space_job")
    jcfg = JTrainConfig()
    jcfg.model = JModelConfig(name="unet2", compute_dtype="float32")
    jcfg.data.task = "synthetic"
    jcfg.data.img_size = S
    jcfg.data.batch_size = jcfg.data.eval_batch_size = B
    jcfg.data.num_tta_views = V
    jcfg.data.warp_method = "shear"
    jcfg.coteach.warmup_epochs = EPOCHS
    jcfg.num_epochs = 10
    jcfg.mesh.num_devices = 1
    jcfg.checkpoint_dir = str(tmp / "jax" / "ckpt")
    jcfg.history_dir = str(tmp / "jax" / "hist")
    jtask = JSyntheticTask(root=str(tmp / "jax" / "data"), **TASK_ARGS)
    jtr = JTrainer(jcfg, task=jtask)
    jtr.label_cases = set(jtask.clean_case_ids())

    arrays = {}
    for n in (0, 1):
        sd = variables_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jtr.state.net_variables(n)), "unet")
        arrays.update({f"net{n}.{k}": v for k, v in sd.items()})
    views = [[jtta.sample_view_params(
        jprng.step_key(jprng.epoch_key(jtr.root_key, e), i), V, B,
        jcfg.data.rotation_degree, jcfg.data.hflip_prob) for i in range(STEPS)]
        for e in range(EPOCHS)]
    arrays["degrees"] = np.array([[np.array(d) for d, _ in row] for row in views])
    arrays["hflip"] = np.array([[np.array(h) for _, h in row] for row in views])
    cfg = TrainConfig.from_dict(jcfg.to_dict())
    port = {}

    def run_port():
        for layout, (world, axes) in LAYOUTS.items():
            cfg.mesh.num_devices, cfg.mesh.extra_axes = world, axes
            spec = {"cfg": cfg.to_json(), "task": TASK_ARGS, "epochs": EPOCHS}
            name = layout.replace(" ", "_")
            np.savez(tmp / f"inputs_{name}.npz", spec=json.dumps(spec), **arrays)
            try:
                port[layout] = mesh.launch(train_job, cfg, "cpu",
                                           (str(tmp / f"inputs_{name}.npz"), str(tmp / name)))
            except Exception as err:  # a failed rank: raised below, in the test's thread
                port[layout] = err

    thread = threading.Thread(target=run_port)
    thread.start()
    try:
        jtr.run(EPOCHS)
    finally:
        thread.join()
    out = {"jax": jtr, "tmp": tmp, "cfg": cfg}
    for layout, (world, _) in LAYOUTS.items():
        if isinstance(port[layout], Exception):
            raise port[layout]
        results = []
        for r in range(world):
            res = dict(port[layout][r])
            with np.load(tmp / layout.replace(" ", "_") / f"rank{r}" / "state.npz") as z:
                res["state"] = {k: z[k] for k in z.files}
            results.append(res)
        out[layout] = results
    return out


def _metrics(history):
    return [{k: v for k, v in row.items() if not k.startswith("time")} for row in history]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_ran_with_the_axis_live(job, layout):
    world, axes = LAYOUTS[layout]
    net = dict(axes).get("net", 1)
    assert [(r["rank"], r["world"], r["net_size"], r["space_size"], r["space_live"], r["held"])
            for r in job[layout]] == [(r, world, net, 2, True, [(r // 2) % 2] if net > 1 else
                                       [0, 1]) for r in range(world)]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_history_matches_jax(job, layout):
    """tests/test_mesh_axes.py's bars: dice within 0.08 at epoch 1 (a
    thresholded metric of a tiny net near its decision boundary), losses
    within rtol 3e-2 (atol 2e-3 at epoch 1, 2e-2 at epoch 2), the other
    keys equal."""
    jh, th = _metrics(job["jax"].history), job[layout][0]["history"]
    assert len(th) == len(jh) == EPOCHS
    for e, (j, t) in enumerate(zip(jh, th)):
        assert set(t) == set(j)
        for key, v in j.items():
            if "dice" in key:
                if e == 0:
                    assert abs(t[key] - v) < 0.08, (key, t[key], v)
            elif "loss" in key:
                np.testing.assert_allclose(t[key], v, rtol=3e-2, atol=2e-3 if e == 0 else 2e-2,
                                           err_msg=key)
            else:
                assert t[key] == v, key


@pytest.mark.parametrize("net", [1, 2])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_working_labels_near_jax(job, layout, net):
    """The same cases refreshed to working labels under 2% of pixels apart
    (tests/test_mesh_axes.py's bar)."""
    got = job[layout][0]["state"][f"labels{net}"]
    want = np.asarray(job["jax"].train_pipe.labels.get(net))
    assert float(np.mean(got != want)) < 0.02


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_ranks_agree(job, layout):
    """Every rank ends with the same history, refresh decisions and
    working labels (host and device), the ranks of a net with the same
    parameters and BN statistics."""
    first = job[layout][0]
    net = dict(LAYOUTS[layout][1]).get("net", 1)
    for res in job[layout]:
        assert res["history"] == first["history"]
        assert res["refresh_log"] == first["refresh_log"]
        for n in (1, 2):
            np.testing.assert_array_equal(res["state"][f"labels{n}"], first["state"][f"labels{n}"])
            np.testing.assert_array_equal(res["state"][f"device_labels{n}"],
                                          res["state"][f"labels{n}"])
        partner = job[layout][((res["rank"] // 2) % 2) * 2 if net > 1 else 0]
        for k, v in partner["state"].items():
            if k.startswith("net"):
                np.testing.assert_array_equal(res["state"][k], v, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_files_written_once(job, layout):
    files = job[layout][0]["files"]
    assert any(f.startswith("hist/") and f.endswith("_history.json") for f in files)
    assert any(f.startswith("hist/") and f.endswith(".log") for f in files)
    assert any(f.endswith("_last_full.msgpack") for f in files)
    assert any(f.startswith("data/tempmasks") for f in files)
    for res in job[layout][1:]:
        assert res["files"] == []


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_job_last_full_resumes_in_one_process(job, layout):
    """Rank 0's _last_full holds the pair: a one-process trainer resumed
    from it holds the ranks' nets bit for bit."""
    cfg = job["cfg"]
    work = job["tmp"] / layout.replace(" ", "_") / "rank0"
    one = TrainConfig.from_json(cfg.to_json())
    one.mesh.num_devices, one.mesh.extra_axes = 1, ()
    one.resume_file = ckpt.full_path(str(work / "ckpt"), cfg.experiment_name, last=True)
    one.checkpoint_dir = one.history_dir = str(job["tmp"] / f"resume_{layout.replace(' ', '_')}")
    tr = ttrainer.Trainer(one, SyntheticTask(root=str(work / "data"), **TASK_ARGS), device="cpu")
    assert tr.start_epoch == EPOCHS and tr.state.optimizer.count == EPOCHS * STEPS
    net = dict(LAYOUTS[layout][1]).get("net", 1)
    for k, held in enumerate(tr.state.nets):
        rank = job[layout][2 * k if net > 1 else 0]
        for name, v in held.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), rank["state"][f"net{k}.{name}"], err_msg=name)


# ------------------------------ the sizing ------------------------------

SIZING = {
    # name: (model, img_size, warp method, live, the words logged)
    "does not divide": ("unet2", 33, "auto", False,
                        "mesh 'space' axis (2) does not divide img_size=33 — spatial "
                        "partitioning disabled"),
    "too few rows": ("unet2", 16, "auto", False,
                     "leaves 0.5 rows a rank at level 5 of unet2"),
    "halo too wide": ("unetsa", 64, "auto", False,
                      "leaves 2 rows a rank at level 5 of unetsa, whose pools need whole rows "
                      "and whose widest halo is 4 rows"),
    "routing": ("unet2", 32, "auto", True,
                "space axis active: each TTA warp all-gathers its source rows over the space "
                "group and writes this rank's 16 output rows"),
    "gather": ("unet2", 32, "gather", True,
               "data.warp_method='gather' with an active space axis"),
}


@pytest.fixture(scope="module")
def sizing(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space_sizing")
    cfgs = []
    for model, size, method, _, _ in SIZING.values():
        cfg = TrainConfig()
        cfg.model.name, cfg.model.compute_dtype = model, "float32"
        cfg.model.base_width = 2
        cfg.data.task, cfg.data.img_size, cfg.data.warp_method = "synthetic", size, method
        cfg.data.batch_size = cfg.data.eval_batch_size = 4
        cfg.mesh.num_devices, cfg.mesh.extra_axes = 2, (("space", 2),)
        cfgs.append(cfg.to_json())
    task = dict(TASK_ARGS, num_cases=2, slices_per_case=2, size=16)
    cfg = TrainConfig()
    cfg.data.batch_size = cfg.data.eval_batch_size = 4
    cfg.mesh.num_devices, cfg.mesh.extra_axes = 2, (("space", 2),)
    return mesh.launch(unit_checks, cfg, "cpu",
                       ({"sizing": {"cfgs": cfgs, "task": task, "workdir": str(tmp)}},))


@pytest.mark.parametrize("case", list(SIZING))
def test_trainer_sizes_the_space_axis(sizing, case):
    """Each rank turns the axis off (with a warning) or keeps it (with the
    routing line) alike; the words are the JAX trainer's where it has
    them."""
    i = list(SIZING).index(case)
    _, _, _, live, words = SIZING[case]
    for res in sizing.values():
        got = res["sizing"][i]
        assert got["live"] == live
        level = "WARNING" if (not live or case == "gather") else "INFO"
        assert any(lvl == level and words in msg for lvl, msg in got["lines"]), got["lines"]


def test_space_axis_outside_launch_raises():
    """A process that launch did not start refuses a space axis, naming
    launch."""
    cfg = TrainConfig()
    cfg.mesh.extra_axes = (("space", 2),)
    with pytest.raises(ValueError, match=r"mesh.extra_axes=\(\('space', 2\),\).*mesh.launch"):
        ttrainer.check_mesh(cfg)


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("name", ["unet2", "unetsa", "fuseunet", "fuseunetsa",
                                  "fuseunetsaseparate"])
def test_space_needs_match_the_built_net(name, dilation):
    """``models.space_needs``, what the trainer sizes the axis by without
    building the net, is the built net's: its widest conv padding (the
    halo) and its up blocks, one a pool."""
    from aide_tpu_torch.models import build_model, space_needs

    cfg = TrainConfig()
    cfg.model.name, cfg.model.base_width, cfg.model.attention_dilation = name, 2, dilation
    net = build_model(cfg.model)
    halo = max(m.padding[0] for m in net.modules() if isinstance(m, torch.nn.Conv2d))
    pools = sum(1 for child, _ in net.named_children() if child.startswith("up_block"))
    assert space_needs(cfg.model) == (pools, halo)
