"""What the real-data CHAOS programs share: where the reference's CHAOS tree
lies, its manifests read and written as pandas reads and writes them, and
the flags the port adds to the JAX programs' (``--reference``, ``--device``).

The reference ships the DICOM slices and ground truth of CHAOS cases 10 and
37 under ``{reference}/inputs_chaos/All_Sets`` and the manifests under
``{reference}/inputs_chaos/All_Sets_split``. The programs read that tree and
never write under it. ``REFERENCE``, the default of ``--reference``, is
``reference/`` at the repository's root; ``aide_tpu_torch.data.fixtures.
write_reference_chaos`` writes a seeded tree in the same layout.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Sequence, Tuple

REFERENCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "reference"
)


def chaos_paths(reference: str) -> Tuple[str, str]:
    """(All_Sets, All_Sets_split) of the reference tree at ``reference``,
    absolute (the symlinks of a work root point at them)."""
    base = os.path.join(os.path.abspath(reference), "inputs_chaos")
    return os.path.join(base, "All_Sets"), os.path.join(base, "All_Sets_split")


def read_table(path: str) -> Tuple[List[str], List[List[str]]]:
    """A manifest's header and rows, as strings."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise ValueError(f"{path!r} is empty")
    return rows[0], rows[1:]


def write_table(path: str, header: Sequence[str], rows: Sequence[Sequence]) -> None:
    """What pandas' ``DataFrame.to_csv(path, index=False)`` writes: minimal
    quoting and ``os.linesep`` line ends."""
    with open(path, "w", newline="") as fh:
        out = csv.writer(fh, lineterminator=os.linesep)
        out.writerow(header)
        out.writerows(rows)


def write_cases(path: str, cases: Sequence[int]) -> str:
    """A case list (one ``patient_case`` column); returns ``path``."""
    write_table(path, ["patient_case"], [[c] for c in cases])
    return path


def require_rows(path: str, header: Sequence[str], rows: Sequence[Sequence[str]], case: str,
                 count: int = 0) -> List[List[str]]:
    """The rows of the manifest at ``path`` (``Inphase``, ``Outphase`` and
    ``Mask`` columns) whose in-phase path lies under ``case``'s folder:
    ``count`` of them (any number above 0 for 0), else ValueError."""
    missing = {"Inphase", "Outphase", "Mask"} - set(header)
    if missing:
        raise ValueError(f"{path!r} has no {sorted(missing)} column")
    col = list(header).index("Inphase")
    found = [list(r) for r in rows if r[col].startswith(f"{case}/")]
    if len(found) != count if count else not found:
        raise ValueError(f"{path!r} lists {len(found)} rows of case {case}, expected "
                         f"{count or 'some'}")
    return found


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--reference", default=REFERENCE,
                    help="the reference repository's root, which holds "
                         "inputs_chaos/All_Sets and All_Sets_split (read only)")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the first CUDA card; "
                         "'cpu' runs on the CPU)")
