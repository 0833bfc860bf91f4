"""A copy of the benchmark's tree in a temporary directory, with the cells
cut to a size the CPU runs in seconds: base width 4, 32 px, 4 train cases
of 4 slices (2 refreshed a net), batch 4. ``float32`` runs the port in float32, where it has
to agree with the reference to round-off."""

from __future__ import annotations

import json
import os
import shutil
import time

import torch

from benchmark import manifest as mf
from benchmark import run

CELLS = {
    "chaos_coteach_epoch": ("chaos_fuseunet32", "coteach_epochs"),
    "chaos_supervised_epoch": ("chaos_fuseunet32", "supervised_epochs"),
}


def make_tree(root: str, dtype: str = "float32", limits=None) -> dict:
    """A tree at ``root`` holding the benchmark's drivers, metrics and
    traffic, the tiny configurations, and ``limits`` (default: the real
    cells'); returns its manifest."""
    for sub in ("drivers", "metrics", "traffic"):
        shutil.copytree(os.path.join(mf.HERE, sub), os.path.join(root, sub))
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "limits"))
    c = mf.config("chaos_fuseunet32")
    # the refresh rewrites int(0.5 * 4) = 2 cases a net
    c.update(img_size=32, train_cases=4, slices_per_case=4, test_cases=2, batch_size=4,
             eval_batch_size=4, update_percent=0.5)
    c["model"].update(base_width=4, compute_dtype=dtype)
    with open(os.path.join(root, "configs", "chaos_fuseunet32.json"), "w") as fh:
        json.dump(c, fh)
    for cell in CELLS:
        lim = {"limits": limits or mf.limits(cell)}
        with open(os.path.join(root, "limits", f"{cell}.json"), "w") as fh:
            json.dump(lim, fh)
    manifest = mf.load()
    with open(os.path.join(root, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    return manifest


def run_tiny(manifest: dict, cell: str, root: str, trace: bool = False, seed: int = 2**31 + 7,
             seconds: float = 1.0) -> dict:
    torch.set_num_threads(2)
    return run.run_cell(manifest, cell, seed, seconds, trace, torch.device("cpu"),
                        time.perf_counter(), root=root)
