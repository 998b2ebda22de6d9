"""BENCHMARK.json against its required shape, and each name it gives
against the file that the harness looks for."""
import json
import re

import pytest

from reachbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = manifest.Manifest()
D = M.data
E2E = {m["name"]: m for m in D["end_to_end"]}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
ALL_METRICS = D["end_to_end"] + D["per_layer"]


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(D) == KEYS["top"]
    assert D["command"] == ["python3", "reachbench/run.py"]
    assert D["paths"] == ["reachbench"]
    assert isinstance(D["run_seconds"], int) and 1 <= D["run_seconds"] <= 51
    assert len(json.dumps(D)) < 64 * 1024


@pytest.mark.parametrize("entry", D["configs"], ids=lambda c: c["name"])
def test_configs(entry):
    assert set(entry) == KEYS["config"]
    assert NAME.match(entry["name"]) and _line(entry["why"])
    assert _line(entry["source"]) and entry["source"].startswith("https://")
    assert entry["file"].startswith("reachbench/configs/")
    cfg = json.loads((M.root / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert {"graph", "index", "k_max", "guarantee", "assumed"} <= set(cfg)
    assert any(w["config"] == entry["name"] for w in D["workloads"])


@pytest.mark.parametrize("cell", D["workloads"], ids=lambda w: w["name"])
def test_workloads(cell):
    assert set(cell) == KEYS["workload"]
    assert NAME.match(cell["name"])
    assert NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["config"] in M.configs and cell["chips"] in (1, 4)
    mix = M.traffic(cell)
    assert mix["loop"] in ("open", "closed")
    reported = M.metrics(cell, trace=False)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert M.metrics(cell, trace=True)


def test_cells_are_distinct_pairs():
    pairs = [(w["config"], w["traffic"]) for w in D["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len({w["name"] for w in D["workloads"]}) == len(pairs)


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_readers(m):
    group = "end_to_end" if m["name"] in E2E else "per_layer"
    assert set(m) - {"workloads"} == KEYS[group]
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert callable(M.reader(m["name"]))
    for cell in m.get("workloads", []):
        assert cell in M.cells
    if group == "end_to_end":
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert _line(m["layer"])


@pytest.mark.parametrize("m", D["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_of_each_of_its_cells(m):
    assert m["moves"] in E2E
    for cell in m.get("workloads", M.cells):
        got = {e["name"] for e in M.metrics(M.cell(cell), trace=False)}
        assert m["moves"] in got, (m["name"], cell)


def test_metric_names_are_unique_and_layers_are_one_spelling():
    names = [m["name"] for m in ALL_METRICS]
    assert len(set(names)) == len(names)
    layers = {m["layer"] for m in D["per_layer"]}
    for a in layers:     # one layer, one spelling: no name that differs
        for b in layers:  # from another only in case or spaces
            if a != b:
                assert re.sub(r"\s", "", a.lower()) != re.sub(
                    r"\s", "", b.lower())


def test_shares_are_percent():
    for m in D["per_layer"]:
        if m["name"].endswith("_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"
