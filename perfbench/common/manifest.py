"""Everything by name: ``BENCHMARK.json`` at the repository's root names
the cells, configurations and metrics; each has a file of its own under
``perfbench/``, found by that name:

- a configuration: ``configs/<name>.json`` (its sizes as run, its source,
  what was assumed and what was cut);
- a traffic mix: ``traffic/<name>.json`` (parameters that the driver it
  names reads; the driver is ``drivers/<driver>.py``);
- a per-layer metric: ``metrics/<name>.py`` (its layer, unit, the
  end-to-end metric it moves, and ``read(run)``).
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module(os.path.join(HERE, "drivers", f"{name}.py"), f"perfbench_driver_{name}")


def metric(name: str) -> ModuleType:
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   "perfbench_metric_" + name.replace(".", "_").replace("-", "_"))


def cell(name: str, man: dict = None) -> dict:
    man = man or manifest()
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json names no workload {name!r}")


def applies(metric_entry: dict, cell_name: str) -> bool:
    return "workloads" not in metric_entry or cell_name in metric_entry["workloads"]


def end_to_end(cell_name: str, man: dict = None) -> List[dict]:
    man = man or manifest()
    return [m for m in man["end_to_end"] if applies(m, cell_name)]


def per_layer(cell_name: str, man: dict = None) -> List[dict]:
    man = man or manifest()
    return [m for m in man["per_layer"] if applies(m, cell_name)]


def per_layer_modules(cell_name: str, man: dict = None) -> Dict[str, ModuleType]:
    return {m["name"]: metric(m["name"]) for m in per_layer(cell_name, man)}


def limits(cell_name: str) -> dict:
    """The correctness check's limits of a cell, name -> limit, from
    ``limits/<cell>.json`` (which keeps beside each limit the readings it
    was set from and why)."""
    return {name: entry["limit"] for name, entry in _json("limits", cell_name).items()}
