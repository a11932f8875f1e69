"""A cell of ``BENCHMARK.json`` and the files that belong to it, found by name.

Nothing here knows a cell, a configuration, a traffic mix or a metric: a
later change adds one by adding its file and its entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

#: the checkout's root and the benchmark's folder
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} {name!r} in BENCHMARK.json; there are "
                   f"{sorted(e['name'] for e in entries)}")


def load_benchmark(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Dict:
    return _json(path)


def cell(bench: Dict, name: str) -> Dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: Dict, name: str) -> Dict:
    return _json(os.path.join(ROOT, _named(bench["configs"], name, "config")["file"]))


def traffic(name: str) -> Dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> Dict[str, float]:
    return _json(os.path.join(HERE, "limits", f"{cell_name}.json"))["limits"]


def task(name: str):
    return importlib.import_module(f"benchmark.tasks.{name}")


def metric_reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run has nothing it reads."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
