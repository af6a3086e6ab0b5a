"""Every configuration, traffic mix, cell and metric that BENCHMARK.json
names loads by name from its own file, and BENCHMARK.json keeps to its
format: its keys, names, units, bounds and run length."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import bench

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for word in SPEC["command"][1:]:
        assert word.startswith("portbench/")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_loads_by_name(entry):
    conf = bench.load("configs", entry["name"])
    assert conf["name"] == entry["name"]
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert conf["reduced"] == entry["reduced"]
    assert (bench.HERE / "inputs" / f"{conf['inputs']}.py").exists()
    assert set(entry) == {"name", "source", "file", "reduced", "why"}


CELL_FILES = sorted(p.stem for p in (bench.HERE / "workloads").glob("*.json"))


def test_every_cell_has_its_file():
    assert {e["name"] for e in SPEC["workloads"]} <= set(CELL_FILES)


@pytest.mark.parametrize("name", CELL_FILES)
def test_cell_loads_by_name(name):
    """Each cell's file, and the entry of BENCHMARK.json that names it
    (a cell left out of BENCHMARK.json keeps its file for a later change)."""
    work = bench.cell(name)
    assert work["name"] == name and len(work["why"]) <= 200
    entry = {e["name"]: e for e in SPEC["workloads"]}.get(name)
    if entry is not None:
        assert (work["config"], work["traffic"], work["chips"], work["why"]) == (
            entry["config"], entry["traffic"], entry["chips"], entry["why"])
        assert entry["chips"] == 1
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert set(work["limits"]) == {"start_x_ds", "fields_changed", "step_v_share",
                                   "step_rho_share", "step_x_ds"}
    for key in ("skin_radii", "cell_factor", "warmup_steps", "samples", "trace_steps"):
        assert key in work


@pytest.mark.parametrize("entry", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader_by_name(entry):
    assert callable(bench.reader(entry["name"]))
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    if entry in SPEC["per_layer"]:
        assert entry["moves"] == "particle_steps_per_s"
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = [m["name"] for m in bench.metrics(SPEC, False)]
    assert "setup_s" in e2e and len(e2e) >= 2 and bench.metrics(SPEC, True)
    # No metric is limited to some cells: every cell reports each.
    assert not [m for m in SPEC["end_to_end"] + SPEC["per_layer"] if "workloads" in m]


def test_run_names_no_cell_config_or_metric():
    text = "".join((bench.HERE / f).read_text() for f in ("run.py", "bench.py"))
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert not [n for n in names if re.search(rf"\b{re.escape(n)}\b", text)]
