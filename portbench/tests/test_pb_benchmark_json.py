"""BENCHMARK.json against the contract's shape, and discovery by name:
every cell, configuration, traffic mix, traffic kind and per-layer metric
it names is found in its own file."""

from __future__ import annotations

import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51 and int(bench["run_seconds"]) == bench["run_seconds"]


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert common.config(c["name"])["reduced"] == c["reduced"]
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cells.add(w["name"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in common.end_to_end_for(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = common.per_layer_for(bench, w["name"])
        assert layer, w["name"]
        assert {m["moves"] for m in layer} <= e2e


def test_discovery_by_name(bench):
    for w in bench["workloads"]:
        cell = common.cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["why"] == w["why"]
        common.config(cell["config"])
        kind = common.traffic(common.mix(cell["traffic"])["kind"])
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(kind, fn)), (w["name"], fn)
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for m in bench["per_layer"]:
        mod = common.layer(m["name"])
        assert callable(mod.install) and callable(mod.read), m["name"]


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        common.cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        common.layer("no.such_metric")
