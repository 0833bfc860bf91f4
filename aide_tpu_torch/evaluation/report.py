"""Evaluation artifacts in the reference's output schema.

An own copy of ``aide_tpu.evaluation.report`` without pandas: the per-case
CSV ``Patient_case,Dice,IoU,TP,TN,FP,FN`` through the csv module, byte for
byte what ``pandas.DataFrame.to_csv(index=False)`` writes for the same
results, and per-slice PNG masks with foreground stored as fg*scale.
"""

from __future__ import annotations

import csv
import os
from typing import List, Sequence

import numpy as np

from aide_tpu_torch.data.io import png
from aide_tpu_torch.evaluation.case_eval import CaseResult

HEADER = ("Patient_case", "Dice", "IoU", "TP", "TN", "FP", "FN")
_FIELDS = ("case_id", "dice", "iou", "tp", "tn", "fp", "fn")


def _column(values: Sequence) -> List[str]:
    """One column's cells as pandas writes them: a missing value (None) is
    an empty cell; numbers are floats (their shortest repr) once the column
    holds a float or a missing value, as pandas' float64 column, and ints
    where all are ints."""
    numbers = [v for v in values if v is not None]
    if not all(isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)
               for v in numbers):
        return ["" if v is None else str(v) for v in values]
    if len(numbers) == len(values) and all(isinstance(v, (int, np.integer)) for v in numbers):
        return [str(int(v)) for v in values]
    return ["" if v is None else repr(float(v)) for v in values]


def write_case_csv(path: str, results: Sequence[CaseResult]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    columns = [_column([getattr(r, f) for r in results]) for f in _FIELDS]
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator=os.linesep)
        writer.writerow(HEADER)
        writer.writerows(zip(*columns))


def write_case_masks(
    out_dir: str,
    case_id: str,
    volume: np.ndarray,
    slice_names: Sequence[str],
    scale: int = 63,
) -> None:
    """Per-slice PNGs under <out_dir>/<case>/ (the evalchaos layout)."""
    folder = os.path.join(out_dir, str(case_id))
    os.makedirs(folder, exist_ok=True)
    for name, sl in zip(slice_names, volume):
        png.write_mask(os.path.join(folder, f"{name}.png"), sl, scale=scale)


def summarize(results: Sequence[CaseResult]) -> dict:
    if not results:
        # a mean over no cases would be NaN in the printed summary
        raise ValueError("no cases evaluated (empty result list)")
    return {
        "mean_dice": float(np.mean([r.dice for r in results])),
        "mean_iou": float(np.mean([r.iou for r in results])),
        "cases": len(results),
    }
