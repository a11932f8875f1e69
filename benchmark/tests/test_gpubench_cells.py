"""BENCHMARK.json against the benchmark's files: every cell names a
configuration, a traffic mix, a task, limits and metrics whose files
exist; and run.py refuses to run without a CUDA GPU."""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import cells  # noqa: E402

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    c = cells.cell(BENCH, cell)
    cfg = cells.config(BENCH, c["config"])
    traffic = cells.traffic(c["traffic"])
    assert cells.task(traffic["task"]).check
    assert cells.limits(cell)
    assert cfg["name"] == c["config"]
    for kind in ("end_to_end", "per_layer"):
        assert cells.metrics_of(BENCH, cell, kind), kind
    for m in cells.metrics_of(BENCH, cell, "per_layer"):
        assert callable(cells.metric_reader(m["name"]))
    assert {"setup_s"} < {m["name"] for m in cells.metrics_of(BENCH, cell, "end_to_end")}


def test_names_units_and_keys():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        assert not m["name"].endswith("roofline") or m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["benchmark"]


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("benchmark/") for f in files)


def test_run_refuses_without_a_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                           "--workload", CELLS[0], "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA GPU" in proc.stderr
