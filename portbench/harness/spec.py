"""The benchmark's own description, found by name: ``BENCHMARK.json`` at
the root of the checkout, a cell's configuration file and traffic file,
its driver module and the reader of each per-layer metric. Nothing here
knows a cell, a configuration or a metric by name: a later change adds
them as files."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration ``name``: its entry in BENCHMARK.json, and its
    file's contents under ``file``'s keys."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return dict(json.load(f), entry=c)
    raise KeyError(f"no config '{name}' in BENCHMARK.json")


def traffic_path(cell: str) -> str:
    return os.path.join(PORTBENCH, "traffic", cell + ".json")


def traffic(cell: str) -> dict:
    """The cell's traffic mix: ``portbench/traffic/<cell>.json``."""
    with open(traffic_path(cell)) as f:
        return json.load(f)


def _load(path: str, modname: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_path(name: str) -> str:
    return os.path.join(PORTBENCH, "drivers", name + ".py")


def driver(name: str) -> ModuleType:
    """``portbench/drivers/<name>.py``."""
    return _load(driver_path(name), "portbench_driver_" + name)


def reader_path(metric: str) -> str:
    return os.path.join(PORTBENCH, "layer_metrics", metric + ".py")


def reader(metric: str) -> ModuleType:
    """``portbench/layer_metrics/<metric>.py``: its ``read(run)`` gives
    the metric's value, or None where the run holds nothing to read."""
    return _load(reader_path(metric),
                 "portbench_metric_" + metric.replace(".", "_"))


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports (``setup_s`` and those whose
    ``workloads`` name it, or that name none)."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those whose ``workloads``
    name it, and those without the key whose ``moves`` the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def metric_units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}
