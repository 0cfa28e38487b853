"""BENCHMARK.json against the contract's shapes, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert all(LINE.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    for c in m.get("workloads", []):
        assert c in CELLS


def test_names_are_unique_and_allowed():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    wl = spec.workload(BENCH, cell)
    cfg = spec.config(BENCH, wl["config"])
    assert cfg["preset"] and cfg["reduced"] == cfg["entry"]["reduced"]
    mix = spec.traffic(cell)
    assert os.path.isfile(spec.driver_path(mix["driver"]))
    assert hasattr(spec.driver(mix["driver"]), "Cell")
    assert mix["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(BENCH, cell)
    assert layers
    for m in layers:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_reader_is_found(m):
    assert os.path.isfile(spec.reader_path(m["name"]))
    assert callable(spec.reader(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_config_is_used_and_its_file_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
