"""The benchmark's kidney configuration (``benchmark/configs/kidney_unet64.json``)
against its plain reference (``benchmark/reference/kidney.py``) on the CPU.

At 64 px, UNet base width 8, seeded He-normal weights (``benchmark.weights``)
and every knob of the configuration (eval-mode TTA views, p^(1/T)
sharpening, lr 1e-5, the refresh that skips an empty prediction, the
ascending gate), the port runs the warm-up epoch as the cell's driver runs
it (``benchmark/drivers/kidney_epochs.py``): its first 3 co-teaching steps
are held to the reference's (the losses, the first gradient, each leaf's
change, the running statistics that the views of steps 2 and 3 read), and
its case evaluation and per-image refresh, with one image's prediction
planted empty on both sides, to the reference's evaluation and refresh:
the selection and the rewritten labels exactly. A bf16 run fails the
tolerances; a reference whose BatchNorm folds nothing does too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import checks, common, manifest as mf, weights
from benchmark.drivers import kidney_epochs
from benchmark.drivers.epochs import EpochAnswers, FirstSteps
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import kidney as ref_kidney

SEED = 2**31 + 21
STEPS = 3
FIRST = mf.traffic("kidney_coteach_epochs")["first_epoch"]
PLANTED = "case00"  # predicted background by both nets, on both sides: dice 0, first of ties

# float32 on both sides, TF32 off in the reference: what is left is the
# summation order's round-off. Measured at this size: the losses 8e-7, the
# median leaf's first gradient 1e-6 to 2e-4, the worst leaf's change
# 1-3e-2, the running statistics 8e-5 to 1.3e-4; a bf16 port reads 7e-4,
# 2e-2, 0.14 and 4e-3, a reference that folds no statistics 3e-2 in the
# losses.
LOSS_TOL = 1e-5  # relative, each net's loss at each step
# checks.train_numbers' grad_gap (median leaf): round-off flips a max-pool
# or small-loss ranking near-tie now and then, which moves every leaf a
# little (2e-4 read once with other weights)
GRAD_TOL = 1e-3
# the worst leaf's change: AMSGrad's first steps move each element by about
# lr whatever its gradient, so an element whose gradient is near zero
# follows round-off (the cell's limit is 0.4; a state left unchanged reads 1)
UPDATE_TOL = 0.1
# relative to each buffer's largest magnitude: the port folds flax's
# E[x^2] - E[x]^2, the reference the two-pass variance, which part where a
# channel's mean is large beside its spread
RUNNING_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(dtype: str = "float32") -> dict:
    c = mf.config("kidney_unet64")
    # 12 one-image train cases (3 steps of 4; 3 refreshed a net), 4 test
    c.update(img_size=64, train_cases=12, test_cases=4, batch_size=4, eval_batch_size=4)
    c["model"].update(base_width=8, compute_dtype=dtype)
    return c


def _port(config: dict, tmp) -> dict:
    """The port's warm-up epoch as the driver runs it, the train case
    ``PLANTED`` predicted empty by both nets."""
    from aide_tpu_torch.core import trace
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from aide_tpu_torch.engine.trainer import Trainer

    data = common.data_spec(config, SEED)
    cfg = kidney_epochs.train_config(config, "proposed", SEED, str(tmp))
    task = SyntheticTask(root=cfg.data.root, tempmask_folder=cfg.data.tempmask_folder,
                         **common.task_options(data))
    trainer = Trainer(cfg, task=task, device="cpu")
    trainer.label_cases = set(task.clean_case_ids())
    # benchmark.weights takes the conv biases from nn.Conv2d's own init, from
    # the process's generator: seeded here, so that every run of this test
    # loads the same weights whichever tests ran before it
    torch.manual_seed(SEED)
    sds = weights.make(config["model"], SEED ^ 0x5EED, "cpu", 2)
    for net, sd in zip(trainer.state.nets, sds):
        net.load_state_dict(sd)
    recorder, answers = FirstSteps(trainer, STEPS), EpochAnswers(trainer)
    running, step = [], trainer.train_step

    def snapshot(state, *args):
        m = step(state, *args)
        running.append({f"net{k}.{n}": v.clone() for k, net in enumerate(state.nets)
                        for n, v in net.named_buffers()})
        return m

    trainer.train_step = snapshot
    (row,) = trainer.train_pipe.case_indices(PLANTED)
    predict_all = trainer.predict_all
    assert predict_all is not None

    def planted(state, data, idx):
        out = predict_all(state, data, idx)
        hit = torch.from_numpy(np.asarray(idx) == row)
        return out.masked_fill(hit[:, None, :, None, None], 0)

    trainer.predict_all = planted
    before = trace.totals()
    trainer.run_epoch(FIRST)
    spent = trace.delta(before)
    evaluated = answers.finish(FIRST)
    return {"steps": recorder.readings, "running": running, "evaluated": evaluated,
            "sds": sds, "data": data, "spent": spent,
            "refreshed": kidney_epochs.refreshed_images(trainer, FIRST)}


@pytest.fixture(scope="module")
def port32(tmp_path_factory):
    return _port(_config(), tmp_path_factory.mktemp("kidney32"))


@pytest.fixture(scope="module")
def reference(port32):
    return ref_kidney.readings(_config(), port32["data"], True, port32["sds"], SEED, FIRST, STEPS,
                               "cpu")


def _step_gaps(port: dict, ref: dict) -> dict:
    loss = max(abs(p - r) / abs(r) for ps, rs in zip(port["steps"]["losses"], ref["losses"])
               for p, r in zip(ps, rs))
    running = max(float((port["running"][STEPS - 1][k] - v).abs().max()
                        / v.abs().max().clamp(min=1e-6)) for k, v in ref["running"].items())
    return dict(checks.train_numbers(port["steps"], ref), loss=loss, running=running)


def _within(gaps: dict) -> dict:
    """Each tolerance: whether the gaps keep to it."""
    return {"loss": gaps["loss"] <= LOSS_TOL, "grad_gap": gaps["grad_gap"] <= GRAD_TOL,
            "update_gap": gaps["update_gap"] <= UPDATE_TOL,
            "running": gaps["running"] <= RUNNING_TOL}


def test_three_steps_agree_with_the_reference(port32, reference):
    gaps = _step_gaps(port32, reference)
    assert all(_within(gaps).values()), gaps
    # steps 2 and 3 viewed with the statistics that the steps before folded:
    # they moved from the seeded (0, 1) by more than the tolerance
    first, third = port32["running"][0], port32["running"][STEPS - 1]
    for k, v in third.items():
        if k.endswith("running_var"):
            assert float((v - 1.0).abs().max()) > 100 * RUNNING_TOL, k
            assert not torch.equal(v, first[k]), k


def test_a_reference_that_folds_nothing_fails(port32, monkeypatch):
    monkeypatch.setattr(ref_kidney, "MOMENTUM", 0.0)
    still = ref_kidney.readings(_config(), port32["data"], True, port32["sds"], SEED, FIRST, STEPS,
                                "cpu")
    assert not all(_within(_step_gaps(port32, still)).values())


def test_a_bf16_run_fails_the_tolerances(tmp_path, reference):
    port16 = _port(_config("bfloat16"), tmp_path)
    assert not all(_within(_step_gaps(port16, reference)).values())


def test_the_evaluation_and_the_refresh_skip_the_planted_image(port32):
    config, data, evaluated = _config(), port32["data"], port32["evaluated"]
    ref = ref_eval.answers(config, data, evaluated["weights"], "cpu")
    for net in (0, 1):
        empty = np.zeros_like(ref["raw"]["train", net, PLANTED])
        ref["raw"]["train", net, PLANTED] = empty
        ref["pred"][net][PLANTED] = empty
        ref["dice"]["train", net, PLANTED] = ref_eval.dice(empty, ref["initial"][PLANTED])
    k = int(config["update_percent"] * data["train_cases"])
    got = checks.epoch_numbers(evaluated, ref, k, [], True)
    # the same labels on both sides in float32 (no argmax near-tie at this
    # size), and each stage after the predict program exact
    assert got["predict_gap"] < 1e-6, got
    for name in ("cc_gap", "dice_gap", "refresh_rank_gap", "refresh_label_gap"):
        assert got[name] == 0.0, got
    images = {"refresh.images": 0, "refresh.skipped_empty": 0}
    for net in (0, 1):
        dice_of = {c: d for (kind, n, c), d in ref["dice"].items()
                   if kind == "train" and n == net}
        selected, labels = ref_eval.refresh(dice_of, ref["pred"][net], ref["initial"], k, [],
                                            True)
        assert sorted(evaluated["selected"][net]) == sorted(selected)
        assert PLANTED in selected
        for case, lab in labels.items():
            assert np.array_equal(evaluated["labels"][net][case], lab), (net, case)
        assert np.array_equal(evaluated["labels"][net][PLANTED], ref["initial"][PLANTED])
        for case in selected:
            empty = not ref["pred"][net][case].any()
            images["refresh.skipped_empty" if empty else "refresh.images"] += 1
    # one image a case; both branches taken
    assert images["refresh.images"] >= 1 and images["refresh.skipped_empty"] >= 2
    assert {name: port32["spent"].get(name, 0) for name in images} == images
    # the driver's count, from the refresh log, leaves the skipped image out too
    assert port32["refreshed"] == images["refresh.images"]


def test_the_driver_maps_every_configuration_key(tmp_path):
    c = mf.config("kidney_unet64")
    cfg = kidney_epochs.train_config(c, "proposed", 7, str(tmp_path))
    task = common.task_options(common.data_spec(c, 7))
    m, d, ct = cfg.model, cfg.data, cfg.coteach
    onto = {
        "model": {k: getattr(m, k) for k in c["model"]} == c["model"],
        "img_size": d.img_size == task["size"] == c["img_size"],
        "two_modal": task["two_modal"] is c["two_modal"],
        "train_cases": task["num_cases"] == c["train_cases"],
        "slices_per_case": task["slices_per_case"] == c["slices_per_case"],
        "test_cases": task["num_test_cases"] == c["test_cases"],
        "test_case_offset": task["test_case_offset"] == c["test_case_offset"],
        "clean_cases": task["clean_cases"] == c["clean_cases"],
        "noisy_fraction": task["noisy_fraction"] == c["noisy_fraction"],
        "batch_size": d.batch_size == c["batch_size"],
        "eval_batch_size": d.eval_batch_size == c["eval_batch_size"],
        "num_tta_views": d.num_tta_views == c["num_tta_views"],
        "rotation_degree": d.rotation_degree == c["rotation_degree"],
        "lr": cfg.optim.lr == c["lr"],
        "warmup_epochs": ct.warmup_epochs == c["warmup_epochs"],
        "update_percent": ct.update_percent == c["update_percent"],
        "refresh_skip_empty": ct.refresh_skip_empty is c["refresh_skip_empty"],
        "num_epochs": cfg.num_epochs == c["num_epochs"],
        "sharpen_mode": ct.sharpen_mode == c["sharpen_mode"],
        "temperature": ct.temperature == c["temperature"],
        "tta_bn": ct.tta_bn == c["tta_bn"],
        "ascending_checkpoint_gate": cfg.ascending_checkpoint_gate
        is c["ascending_checkpoint_gate"],
    }
    described = {"name", "source", "deployment", "assumed"}
    assert set(c) == set(onto) | described
    assert [k for k, ok in onto.items() if not ok] == []
    # the table's values, as the AIDE kidney script and the cell set them
    assert (c["model"]["name"], c["model"]["base_width"], c["img_size"]) == ("unet", 64, 512)
    assert (ct.tta_bn, ct.sharpen_mode, cfg.optim.lr) == ("running", "pow_inv_t", 1e-5)
    assert ct.refresh_skip_empty and cfg.ascending_checkpoint_gate
