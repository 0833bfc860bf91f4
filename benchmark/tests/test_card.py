"""On the card: a short run of each cell as the driver makes it, through the
command line, correct, with the contract's result line. Skips without a
CUDA card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import manifest as mf


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in mf.load()["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "5", "--trace", "1"],
        cwd=mf.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
