"""Where the harness finds a cell's parts, by the names ``BENCHMARK.json``
gives them, under a root directory (the checkout):

- ``benchmark/configs/<config>.json``: a configuration;
- ``benchmark/traffic/<traffic>.json``: a traffic mix;
- ``benchmark/limits/<workload>.json``: the limits of a cell's comparison;
- ``benchmark/metrics/<metric>.py``: a metric's reader, ``read(rec)``.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def part(root: str, kind: str, name: str) -> dict:
    """The JSON file ``benchmark/<kind>/<name>.json`` under ``root``."""
    with open(os.path.join(root, "benchmark", kind, f"{name}.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics the cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a ``workloads`` key whose end-to-end metric it
    reports."""
    moved = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", []) or
            ("workloads" not in m and m["moves"] in moved)]


def reader(root: str, name: str) -> Callable[[dict], Optional[float]]:
    """The ``read`` function of ``benchmark/metrics/<name>.py``, loaded by
    path (a metric's name may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(root: str, metrics: List[dict], rec: dict
                 ) -> Dict[str, dict]:
    """Each metric's value over the run's record; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = reader(root, m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
