"""A whole cell run on the CPU (the look for a card skipped) with the timed
path broken underneath: ``correct`` has to come out false, once for each
fault the cell can have: a step that leaves the state unchanged, half of
the batch left out, an answer altered where it is produced, and for
co-teaching a refresh that writes nothing or rewrites the best cases. A
sound run of the same tree passes. The port
runs in float32 at 32 px and base width 4; the limits are the cells' own.
The exchange between cards is no fault of these one-card cells."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.tests import tiny

TRAIN_CELLS = ["chaos_coteach_epoch", "chaos_supervised_epoch"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("faults"))
    return root, tiny.make_tree(root, dtype="float32")


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_sound_run_is_correct(tree, cell):
    root, m = tree
    assert tiny.run_tiny(m, cell, root)["correct"] is True


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_step_that_leaves_the_state_unchanged(tree, cell, monkeypatch):
    from aide_tpu_torch.ops import schedules

    # on each class: torch.optim wraps a subclass's step on its first instance
    for cls in schedules.OPTIMIZERS.values():
        monkeypatch.setattr(cls, "step", lambda self, closure=None: None)
    root, m = tree
    res = tiny.run_tiny(m, cell, root)
    assert res["correct"] is False
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def _half(batch):
    out = {}
    for k, v in batch.items():
        out[k] = v[: v.shape[0] // 2] if torch.is_tensor(v) and v.ndim else v
    return out


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_of_the_batch_left_out(tree, cell, monkeypatch):
    from aide_tpu_torch.engine import steps

    make_coteach, make_supervised = steps.make_coteach_train_step, steps.make_supervised_train_step

    def coteach(*a, **kw):
        step = make_coteach(*a, **kw)

        def half(state, batch, degrees, hflip, rate, *rest):
            b = degrees.shape[1] // 2
            return step(state, _half(batch), degrees[:, :b], hflip[:, :b], rate, *rest)

        return half

    def supervised(*a, **kw):
        step = make_supervised(*a, **kw)
        return lambda state, batch, *rest: step(state, _half(batch), *rest)

    monkeypatch.setattr(steps, "make_coteach_train_step", coteach)
    monkeypatch.setattr(steps, "make_supervised_train_step", supervised)
    root, m = tree
    assert tiny.run_tiny(m, cell, root)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_an_answer_altered_where_it_is_produced(tree, cell, monkeypatch):
    from aide_tpu_torch.evaluation import case_eval

    keep = case_eval.keep_largest_connected_components

    def altered(vol):
        out = keep(vol).copy()
        out[len(out) // 2] ^= 1
        return out

    monkeypatch.setattr(case_eval, "keep_largest_connected_components", altered)
    root, m = tree
    res = tiny.run_tiny(m, cell, root)
    assert res["correct"] is False
    assert res["checks"]["cc_gap"]["value"] > res["checks"]["cc_gap"]["limit"]


def test_a_refresh_that_leaves_the_labels_unchanged(tree, monkeypatch):
    from aide_tpu_torch.data.pipeline import LabelStore

    monkeypatch.setattr(LabelStore, "refresh_case", lambda self, *a, **kw: None)
    root, m = tree
    res = tiny.run_tiny(m, "chaos_coteach_epoch", root)
    assert res["correct"] is False
    assert res["checks"]["refresh_label_gap"]["value"] > 0.1


def test_a_refresh_of_the_best_cases(tree, monkeypatch):
    from aide_tpu_torch.engine import trainer

    argsort = trainer.np.argsort

    class Reversed:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def argsort(a, *args, **kw):
            return argsort(-np.asarray(a), *args, **kw)

    monkeypatch.setattr(trainer, "np", Reversed())
    root, m = tree
    res = tiny.run_tiny(m, "chaos_coteach_epoch", root)
    assert res["correct"] is False
    assert res["checks"]["refresh_rank_gap"]["value"] > res["checks"]["refresh_rank_gap"]["limit"]
