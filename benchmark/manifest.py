"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The harness finds each by its name alone:

* ``benchmark/configs/<config>.json``: the sizes of the network and its
  dataset, as the cell runs them;
* ``benchmark/traffic/<traffic>.json``: the window driver (``driver``, a
  module ``benchmark/drivers/<driver>.py``) and its parameters;
* ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric, a
  function ``read(record)`` that returns a number or None.

So a later change adds a configuration, a cell or a metric by adding files
and entries, and edits no file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path: Optional[str] = None) -> Dict:
    """The manifest at ``path`` (default: the checkout's BENCHMARK.json),
    checked by ``check``."""
    path = path or os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as fh:
        manifest = json.load(fh)
    errors = check(manifest)
    if errors:
        raise ValueError(f"{path}: " + "; ".join(errors))
    return manifest


def check(manifest: Dict) -> List[str]:
    """What is wrong with a manifest's names, units and references (empty
    when nothing is)."""
    errors = []
    seen = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest.get(section, []):
            name = entry.get("name", "")
            if not NAME.match(name):
                errors.append(f"{section}: bad name {name!r}")
            if name in seen and section in ("configs", "workloads"):
                errors.append(f"{section}: {name!r} twice")
            seen.add((section, name) if section in ("end_to_end", "per_layer") else name)
    metric_names = [m["name"] for m in manifest.get("end_to_end", []) + manifest.get("per_layer", [])]
    if len(set(metric_names)) != len(metric_names):
        errors.append("a metric name appears twice")
    for m in manifest.get("end_to_end", []) + manifest.get("per_layer", []):
        if not UNIT.match(m.get("unit", "")):
            errors.append(f"{m.get('name')}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            errors.append(f"{m.get('name')}: better must be lower or higher")
    configs = {c["name"] for c in manifest.get("configs", [])}
    cells = set()
    for w in manifest.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.match(w.get(key, "")):
                errors.append(f"{w.get('name')}: bad {key} {w.get(key)!r}")
        if w.get("config") not in configs:
            errors.append(f"{w.get('name')}: unknown config {w.get('config')!r}")
        pair = (w.get("config"), w.get("traffic"))
        if pair in cells:
            errors.append(f"{w.get('name')}: config and traffic {pair} twice")
        cells.add(pair)
    for c in manifest.get("configs", []):
        for key in c.get("reduced", []):
            if not NAME.match(key):
                errors.append(f"{c['name']}: bad reduced key {key!r}")
    return errors


def workload(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in the manifest")


def _json(kind: str, name: str, root: str) -> Dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(root, kind, f"{name}.json")) as fh:
        return json.load(fh)


def config(name: str, root: str = HERE) -> Dict:
    """``configs/<name>.json``."""
    return _json("configs", name, root)


def traffic(name: str, root: str = HERE) -> Dict:
    """``traffic/<name>.json``."""
    return _json("traffic", name, root)


def limits(cell: str, root: str = HERE) -> Dict[str, float]:
    """The limit of each compared number of a cell:
    ``limits/<cell>.json``'s ``limits``."""
    return {k: float(v) for k, v in _json("limits", cell, root)["limits"].items()}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, root: str = HERE):
    """The window driver ``drivers/<name>.py``: a module with
    ``run(ctx) -> record``."""
    if not NAME.match(name):
        raise ValueError(f"bad driver name {name!r}")
    return _module(os.path.join(root, "drivers", f"{name}.py"),
                   "benchmark_driver_" + re.sub(r"\W", "_", name))


def reader(metric: str, root: str = HERE):
    """The reader ``read(record)`` of the per-layer metric ``metric``
    (``metrics/<metric>.py``)."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    return _module(os.path.join(root, "metrics", f"{metric}.py"),
                   "benchmark_metric_" + re.sub(r"\W", "_", metric)).read


def cell_metrics(manifest: Dict, section: str, cell: str) -> List[Dict]:
    """The metrics of ``section`` that ``cell`` reports: those without a
    ``workloads`` list and those whose list names it."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]
