"""Every configuration, traffic mix, cell, limit and per-layer metric of
``BENCHMARK.json`` is found by its name under ``perfbench/`` and agrees
with the manifest; the manifest keeps the shape of the benchmark's
contract."""

import json
import os
import re

import pytest

from perfbench.common import manifest
from perfbench.reference import build as rbuild

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_file_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert NAME.match(entry["name"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    cfg = manifest.config(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    # the sizes as run are the reference's (and, by the weights' spec check, the port's)
    assert cfg["sizes"] == json.loads(json.dumps(rbuild.FULL))
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("entry", MAN["workloads"], ids=lambda e: e["name"])
def test_cell_files_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    traffic = manifest.traffic(entry["traffic"])
    assert os.path.isfile(os.path.join(manifest.HERE, "drivers", f"{traffic['driver']}.py"))
    assert hasattr(manifest.driver(traffic["driver"]), "drive")
    limits = manifest.limits(entry["name"])
    assert limits and all(v > 0 for v in limits.values())
    # each limit lies above the sound runs' reading it was set from, and
    # below the control's or a fault's where one gives an upper reading
    for name, e in manifest._json("limits", entry["name"]).items():
        assert e["lower"] < e["limit"] and e["why"], name
        assert e["upper"] is None or e["limit"] < e["upper"], name
    names = [e["name"] for e in manifest.end_to_end(entry["name"], MAN)]
    assert "setup_s" in names and len(names) >= 2
    assert manifest.per_layer(entry["name"], MAN)


def test_names_are_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [e["name"] for e in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", MAN["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_metric(entry):
    assert set(entry) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher") and entry["source"] in E2E_SOURCES
    assert 0.01 <= entry["bound"] <= 0.25


@pytest.mark.parametrize("entry", MAN["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metric_reader_agrees(entry):
    assert set(entry) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    mod = manifest.metric(entry["name"])
    assert mod.LAYER == entry["layer"] and mod.UNIT == entry["unit"] == entry["unit"]
    assert mod.MOVES == entry["moves"] and callable(mod.read)
    assert entry["source"] in SOURCES and entry["better"] in ("lower", "higher")
    assert UNIT.match(entry["unit"]) and 1 <= len(entry["layer"]) <= 200
    # every cell that reports it also reports the end-to-end metric it moves
    for cell in entry.get("workloads", [w["name"] for w in MAN["workloads"]]):
        assert entry["moves"] in [e["name"] for e in manifest.end_to_end(cell, MAN)]
    if entry["name"].endswith("_roofline") or "_roofline." in entry["name"] \
            or "mfu" in entry["name"]:
        assert entry["unit"] == "%"


def test_one_layer_one_name():
    """Metrics of one layer give the same layer, letter for letter."""
    by_layer = {}
    for e in MAN["per_layer"]:
        by_layer.setdefault(e["layer"].split(" ")[0], set()).add(e["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_every_file_is_named_for_an_entry():
    """A configuration, traffic, limit or metric file without its entry
    would be dead weight."""
    here = manifest.HERE
    listed = {
        "configs": {e["name"] for e in MAN["configs"]},
        "traffic": {e["traffic"] for e in MAN["workloads"]},
        "limits": {e["name"] for e in MAN["workloads"]},
        "metrics": {e["name"] for e in MAN["per_layer"]},
    }
    for folder, names in listed.items():
        found = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(here, folder))
                 if not f.startswith((".", "_"))}
        assert found == names, folder
