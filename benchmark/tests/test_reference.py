"""The plain reference against the port on the CPU, at base width 4 and
32 px: its inputs, its warp, its networks and, end to end through a cell
run with the port in float32, its steps, its case evaluation and its
refresh."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import data as ref_data
from benchmark.reference import nets as ref_nets
from benchmark.reference import train as ref_train
from benchmark.reference import warp as ref_warp
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


SPEC = dict(img_size=32, two_modal=True, train_cases=3, slices_per_case=4, test_cases=2,
            test_case_offset=100, clean_cases=1, noisy_fraction=0.5, seed=2**31 + 11)


@pytest.mark.parametrize("two_modal", [True, False])
def test_inputs_are_the_ports(two_modal):
    from aide_tpu_torch.data.pipeline import SlicePipeline
    from aide_tpu_torch.data.tasks.synthetic import SyntheticTask
    from benchmark import common

    spec = dict(SPEC, two_modal=two_modal)
    task = SyntheticTask(root="unused", **common.task_options(spec))
    for train in (True, False):
        pipe = SlicePipeline(task, task.load_manifest(train=train), 32)
        rows = np.arange(len(pipe))
        port = pipe.batch_at(rows)
        ref = ref_data.batch(spec, ref_data.rows_to_slices(spec, rows, train), train, "cpu")
        names = ("modal1", "modal2") if two_modal else ("image",)
        sufs = ("1", "2") if two_modal else ("",)
        for name, suf, img, fill in zip(names, sufs, ref["images"], ref["fills"]):
            x = port[name].float() * port[f"scale{suf}"][:, None, None] + port[f"fill{suf}"][:, None, None]
            torch.testing.assert_close(img, x, rtol=0, atol=2e-5)
            torch.testing.assert_close(fill, port[f"fill{suf}"], rtol=0, atol=1e-6)
        assert torch.equal(ref["target"], port["target"])


@pytest.mark.parametrize("inverse", [False, True])
def test_warp_is_the_kernels_function(inverse):
    from aide_tpu_torch.ops import cuda_warp

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(6, 33, 33, 3, generator=gen)
    deg = torch.tensor([-170.0, -60.0, -45.5, 0.0, 30.0, 125.0])
    flip = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 0.0])
    fill = torch.randn(6, 3, generator=gen)
    port = cuda_warp.warp_rotate_flip(x, deg, flip, fill, inverse=inverse)
    assert torch.equal(ref_warp.warp(x, deg, flip, fill, inverse), port)


@pytest.mark.parametrize("name, width, two", [("fuseunet", 4, True), ("unet", 4, False)])
def test_networks_match_in_float32(name, width, two):
    from aide_tpu_torch.core.config import ModelConfig
    from aide_tpu_torch.models import build_model

    model = {"name": name, "base_width": width, "num_classes": 2}
    port = build_model(ModelConfig(name=name, base_width=width, compute_dtype="float32"))
    ref = ref_nets.build(model)
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    (sd,) = weights.make(model, 3, "cpu", 1)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    gen = torch.Generator().manual_seed(0)
    x = [torch.randn(2, 32, 32, 3, generator=gen) for _ in range(2 if two else 1)]
    # eval mode first: a train-mode forward of the port folds its running
    # statistics
    for mode in (False, True):
        port.train(mode)
        ref.train(mode)
        torch.testing.assert_close(ref(*x), port(*x), rtol=1e-5, atol=1e-5)


def test_draws_are_the_trainers():
    from aide_tpu_torch.core import prng
    from aide_tpu_torch.ops import tta

    seed = 2**31 + 99
    gen = prng.generator(torch.device("cpu"), seed, 9, 2)
    deg, flip = tta.sample_view_params(gen, 4, 8, 60.0, 0.5)
    rdeg, rflip = ref_train.view_params(torch.device("cpu"), seed, 9, 2, 4, 8, 60.0)
    assert torch.equal(deg, rdeg) and torch.equal(flip, rflip)
    order = np.arange(50)
    np.random.default_rng(seed * 100003 + 0 * 1009 + 9).shuffle(order)
    assert np.array_equal(ref_train.shuffle_order(seed, 9, 50), order)


@pytest.fixture(scope="module")
def tree32(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree32"))
    return root, tiny.make_tree(root, dtype="float32")


@pytest.mark.parametrize("cell", ["chaos_coteach_epoch", "chaos_supervised_epoch"])
def test_training_cells_agree_with_the_port_in_float32(tree32, cell):
    root, m = tree32
    res = tiny.run_tiny(m, cell, root)
    numbers = {k: v["value"] for k, v in res["checks"].items()}
    refresh = {"refresh_rank_gap", "refresh_label_gap"} if "coteach" in cell else set()
    assert set(numbers) == {"grad_gap", "update_gap", "predict_gap", "cc_gap",
                            "dice_gap"} | refresh
    # float32 on both sides: round-off alone, which flips a few max-pool
    # and ranking near-ties at this size (bf16 reads 2-6e-3 at the cells'
    # sizes, their limit is 1.5e-2)
    assert numbers["grad_gap"] < 1e-3, numbers
    # the worst leaf's change: AMSGrad's first steps move every element by
    # about lr whatever its gradient, so an element whose gradient is near
    # zero follows the summation order's round-off; at this size that reads
    # up to ~6% in float32 (the cells' limit is 0.4, a state left
    # unchanged reads 1)
    assert numbers["update_gap"] < 0.2, numbers
    # the epoch's evaluation and refresh: the same labels on both sides,
    # and each stage after the predict program exact on the port's output
    assert numbers["predict_gap"] < 1e-6, numbers
    for name in {"cc_gap", "dice_gap"} | refresh:
        assert numbers[name] == 0.0, numbers
