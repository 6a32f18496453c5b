"""Every configuration, traffic, cell, driver, reference engine, metric
and bound loads by name, and BENCHMARK.json keeps to its contract."""

import json
import math
import pathlib
import re

import pytest

from gossipbench import harness

ROOT = pathlib.Path(harness.__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gossipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert NAME.match(cfg["name"])
    data = harness.load_json("configs", cfg["name"])
    assert (ROOT.parent / cfg["file"]).resolve() == \
        ROOT / "configs" / f"{cfg['name']}.json"
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert cfg["reduced"] == data["reduced"] == []
    assert data["n"] == 2 ** 20
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert NAME.match(cell) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    spec = harness.load_json("workloads", cell)
    assert (spec["config"], spec["traffic"], spec["chips"]) == \
        (w["config"], w["traffic"], w["chips"])
    traffic = harness.load_json("traffic", spec["traffic"])
    assert hasattr(harness.load_module("drivers", traffic["driver"]),
                   "Driver")
    assert hasattr(harness.load_module("reference", traffic["reference"]),
                   "call")
    limits = spec["limits"]
    for name in ("nodes_off", "informed_gap", "counter_gap", "clock_off"):
        assert limits[name] >= 0
    assert ("trace_gap" in limits) == \
        (traffic.get("flight_every") is not None)
    assert ("scalars_gap" in limits) == bool(traffic.get("carry"))
    e2e = [m["name"] for m in harness.cell_metrics(cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(cell, "per_layer")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_files(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert callable(harness.load_module("metrics", m["name"]).read)
    for cell in m.get("workloads", []):
        assert cell in CELLS
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)


def test_a_roofline_metric_names_a_bound_file():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            assert (ROOT / "bounds" / f"{kernel}.py").is_file()
            assert m["unit"] == "%"


def test_check_budget_fits():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
    assert not math.isnan(total)
