"""``correct`` at a size the CPU holds, through the harness with its look for
a GPU skipped: a sound run of each cell is correct; its control (the
reference with TF32 operands in the program's place) is not; nor is a run
with any fault the cell can have planted in the program underneath.

On the CPU the program runs its plain route at every width, so the wide
configuration runs at the flagship's width here; the limits are the cell's.
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import calibrate  # noqa: E402
from benchmark.lib import cells, compare, harness  # noqa: E402

BENCH = cells.load_benchmark()
CPU = torch.device("cpu")
#: per task: the traffic at CPU size, and the window's seconds
SIZES = {"consensus": ({"batch": 8, "pool_batches": 2, "check_rows": 8, "warmup_batches": 1},
                       0.5),
         "train": ({"batch": 2, "pool_batches": 3, "checked_steps": 2}, 0.5)}
CPU_CONFIG = {"hidden_size": 128}
SEED = 2 ** 31 + 7
CASES = [(w["name"], cells.traffic(w["traffic"])["task"]) for w in BENCH["workloads"]]


def _run(cell, task):
    traffic, seconds = SIZES[task]
    result, _ = harness.run_cell(BENCH, cell, SEED, seconds, False, CPU, 0.0, traffic,
                                 CPU_CONFIG, log=lambda m: None)
    return result


@pytest.mark.parametrize("cell,task", CASES)
def test_sound_run_is_correct(cell, task):
    result = _run(cell, task)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("cell,task", CASES)
def test_control_is_not_correct(cell, task):
    traffic, seconds = SIZES[task]
    _, control, _ = calibrate.reading(BENCH, cell, SEED, seconds, CPU, control=True,
                                      traffic_overrides=traffic, config_overrides=CPU_CONFIG)
    ok, compared = compare.verdict(control, cells.limits(cell))
    assert not ok, compared


@pytest.mark.parametrize("cell,task,fault", [(c, t, f) for c, t in CASES
                                             for f in calibrate.FAULTS[t]])
def test_planted_fault_is_not_correct(cell, task, fault):
    with calibrate.planted(task, fault):
        result = _run(cell, task)
    assert not result["correct"], result["compared"]
