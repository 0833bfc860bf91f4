"""The readings that the limits of ``kidney_coteach_epoch`` are set from.

    python3 -m benchmark.calibrate_kidney --seeds <n> [--first-seed <s>] [--controls <k>]

``benchmark.calibrate`` at that cell, with the kidney protocol's
TrainConfig (``drivers/kidney_epochs.train_config``) and reference steps
(``reference.kidney.readings``) in place of the ones ``calibrate`` takes
from ``common`` and ``reference.steps``: the same seeds, controls, faults
and output lines.
"""

from __future__ import annotations

import sys
import types
from unittest import mock

from benchmark import calibrate, common
from benchmark.drivers import kidney_epochs
from benchmark.reference import kidney as ref_kidney

CELL = "kidney_coteach_epoch"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    protocol = types.SimpleNamespace(**vars(common))
    protocol.train_config = kidney_epochs.train_config
    with mock.patch.object(calibrate, "common", protocol), \
            mock.patch.object(calibrate, "ref_steps",
                              types.SimpleNamespace(readings=ref_kidney.readings)):
        return calibrate.main(["--workload", CELL] + argv)


if __name__ == "__main__":
    sys.exit(main())
