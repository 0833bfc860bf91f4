"""The numbers that decide ``correct``, from the port's outputs and the
reference's.

Training cells: the first three steps of the warm-up epoch (the window's
own call and feed), against the reference's three steps from the same
weights, rows and view draws.
* ``grad_gap``: the first step's gradient, as AMSGrad got it (its first
  moment over 1 - b1), by the median leaf: each leaf's |norm(port) -
  norm(reference)| over the larger of the reference leaf's norm and the
  median leaf's, the median of those. By the worst leaf it is set by one
  early leaf's flipped max-pool, ReLU and ranking choices, which any
  perturbation makes, and does not tell bf16 from fp8 (PERF.md).
* ``update_gap``: each leaf's change over the three steps, the same gap by
  the worst leaf; leaves whose reference gradient is under a thousandth
  of the median leaf's are left out (a conv bias ahead of BatchNorm: it
  moves by round-off).
The steps' losses are printed beside them and not compared: they read
alike in bf16 and in fp8 (PERF.md).
The epoch's evaluation and refresh: the warm-up epoch's case evaluation
and refreshed labels, each stage held to the reference on what the stage
before it produced, so that no number is a largest component chosen
twice. Which of two near-equal components, or two halves of one joined by
a voxel, is the largest can turn on one voxel's rounding, and training is
not bitwise repeatable on the card: the Dice of the reference's own
component against the port's read 0.109 once, and ~1e-4 on the same seed
run again (PERF.md).
* ``predict_gap``: the widest share of a volume's voxels whose label the
  predict program gives otherwise than the reference's argmax, before the
  largest component, of each net on each test and train case.
* ``cc_gap``: the most voxels by which a kept component differs from the
  reference's largest component of the port's own labels (exact).
* ``dice_gap``: the widest gap between the 3D Dice the epoch reports and
  the reference's Dice of the port's kept component against the case's
  truth or working labels (exact).
* ``refresh_rank_gap`` (co-teaching): by the Dice the port reports, how
  far the best case it chose to refresh lies above the k-th worst; 1 where
  it chose another number of cases (exact).
* ``refresh_label_gap`` (co-teaching): the widest 1 - Dice between a train
  case's working labels after the epoch and what the refresh owes it: the
  port's kept component of the case where the port chose it to be
  rewritten, its first labels elsewhere (exact).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

Readings = Dict[str, object]


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> List[float]:
    median = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], median) for k in keys]


def train_numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` ([[loss of each net] a
    step]), ``grad`` and ``change`` ({leaf: norm})."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the port and the reference took different numbers of steps")
    leaves = sorted(ref["grad"])
    if sorted(prog["grad"]) != leaves or sorted(prog["change"]) != leaves:
        raise ValueError("the port's and the reference's leaves differ")
    median = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= 1e-3 * median]
    return {
        "grad_gap": statistics.median(_leaf_gaps(prog["grad"], ref["grad"], leaves)),
        "update_gap": max(_leaf_gaps(prog["change"], ref["change"], moving)),
    }


def train_diagnostics(prog: Readings, ref: Readings, n: int = 3) -> Dict[str, object]:
    """What the calibration prints beside ``train_numbers``: the first
    step's loss gap, the median leaf's gaps, and the ``n`` worst leaves of
    each leaf gap with their gaps."""
    leaves = sorted(ref["grad"])
    median = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= 1e-3 * median]
    out: Dict[str, object] = {
        "loss_gap": max(abs(p - r) / abs(r) for ps, rs in zip(prog["losses"], ref["losses"])
                        for p, r in zip(ps, rs)),
        "loss_gap_step1": max(abs(p - r) / abs(r)
                              for p, r in zip(prog["losses"][0], ref["losses"][0]))}
    for key, keys in (("grad", leaves), ("change", moving)):
        med = statistics.median(ref[key][k] for k in keys)
        gaps = dict(zip(keys, _leaf_gaps(prog[key], ref[key], keys)))
        out[f"{key}_gap_median_leaf"] = statistics.median(gaps.values())
        out[f"{key}_gap_worst_leaf"] = max(gaps.values())
        out[f"{key}_worst"] = [[k, round(v, 5), round(ref[key][k] / med, 4)]
                               for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n]]
    return out


def epoch_numbers(prog: Readings, ref: Readings, k: int, label_cases, skip_empty: bool
                  ) -> Dict[str, float]:
    """``prog``: the port's ``dice``, ``raw`` (its labels before the largest
    component) and ``kept`` {(kind, net, case): ...} and, with a refresh,
    ``selected`` {net: [cases]} and ``labels`` {net: {train case: (S, H,
    W)}}; ``ref``: ``reference.evaluate.answers``."""
    from benchmark.reference import evaluate as ref_eval

    keys = sorted(ref["raw"])
    if sorted(prog["dice"]) != keys or sorted(prog["kept"]) != keys:
        raise ValueError("the port and the reference evaluated different cases")
    predict = cc = dice = 0.0
    for key in keys:
        kept = prog["kept"][key]
        raw = prog["raw"].get(key, kept)  # no component taken: the kept labels as they came
        predict = max(predict, np.count_nonzero((raw > 0) != (ref["raw"][key] > 0)) / raw.size)
        cc = max(cc, float(np.count_nonzero((kept > 0) != (ref_eval.largest_component(raw) > 0))))
        target = ref["target"][key[0], key[2]]
        dice = max(dice, abs(prog["dice"][key] - ref_eval.dice(kept, target)))
    out = {"predict_gap": float(predict), "cc_gap": cc, "dice_gap": float(dice)}
    if "selected" not in prog:
        return out
    rank = label = 0.0
    for net, chosen in prog["selected"].items():
        dice_of = {c: d for (kind, n, c), d in prog["dice"].items() if kind == "train" and n == net}
        kth = sorted(dice_of.values())[k - 1]
        rank = max(rank, 1.0 if len(set(chosen)) != k else
                   max(0.0, max(dice_of[c] for c in chosen) - kth))
        for case, first in ref["initial"].items():
            owed = prog["kept"]["train", net, case]
            write = (case in chosen and case not in label_cases
                     and not (skip_empty and not owed.any()))
            label = max(label, 1.0 - ref_eval.dice(prog["labels"][net][case],
                                                   owed if write else first))
    out.update(refresh_rank_gap=float(rank), refresh_label_gap=float(label))
    return out


def epoch_worst(prog: Readings, ref: Readings) -> Dict[str, object]:
    """Where ``predict_gap`` reads: the case, and its voxels labelled
    otherwise by the two sides and each side's foreground."""
    def gap(key):
        raw = prog["raw"].get(key, prog["kept"][key])
        return np.count_nonzero((raw > 0) != (ref["raw"][key] > 0))

    key = max(ref["raw"], key=gap)
    raw = prog["raw"].get(key, prog["kept"][key])
    return {"case": list(key), "voxels_apart": int(gap(key)),
            "foreground": [int(np.count_nonzero(raw)), int(np.count_nonzero(ref["raw"][key]))]}
