"""The control at a size the CPU holds: the reference put in the port's
place with its convolutions in fp8 (e4m3 operands, e5m2 gradients) has to
come out not correct under each cell's own limits, and so has each fault
planted in the reference (half of each batch left out, an answer altered
where it is produced, and for co-teaching the refresh left out and the
refresh of the best cases). ``benchmark.calibrate`` reads the same at the
cells' sizes on the card."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, manifest as mf
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("control"))
    tiny.make_tree(root, dtype="bfloat16")
    return root


def _fails(numbers, limits):
    return any(numbers[k] > limits[k] for k in limits if k in numbers)


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_the_control_and_the_faults_fail(tree, cell):
    torch.set_num_threads(2)
    config_name, traffic_name = tiny.CELLS[cell]
    config, traffic = mf.config(config_name, tree), mf.traffic(traffic_name, tree)
    limits = mf.limits(cell)
    out = calibrate.train_seed(config, traffic, 2**31 + 5, torch.device("cpu"), True)
    assert _fails(out["control_fp8"], limits), (out["control_fp8"], limits)
    faults = [k for k in out if k.startswith("fault_") and not k.endswith("_diagnostics")]
    assert len(faults) == (4 if traffic["variant"] == "proposed" else 2), faults
    for fault in faults:
        assert _fails(out[fault], limits), (fault, out[fault], limits)
