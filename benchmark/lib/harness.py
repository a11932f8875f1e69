"""One run of one cell: set-up, the measured window, the comparison, the line.

The task of the cell's traffic (``tasks/<task>.py``) provides ``setup(run)``
(weights, inputs, the program's objects, warm-up of the cell's own shapes),
``window(run, state)`` (the measured window, through :func:`measure`) and
``check(run, state)`` (frees the program's state, runs the reference and
returns the compared numbers). The task's loop calls
``run.submitting(now)`` before each submission of the window.

A cell on more than one chip (``run.chips``) gets the first of them as
``run.device``; its task launches and places whatever processes it needs,
and may set ``run.memory_peak_bytes`` (the fullest chip's peak, where the
work runs in other processes) and ``run.trace``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, Optional, Tuple

from benchmark.lib import cells, compare, trace as slices
from benchmark.lib.spans import Spans
from benchmark.reference.transducer import window_starts

#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "helen_tpu")
#: the share of a traced window before its profiler slice, and the slice's
#: seconds of submissions
PRE_SLICE = 0.3
TRACE_SECONDS = 2.0


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def card_label() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """What one run knows: its cell and files, its seed, its spans and
    what its window and its trace measured."""

    def __init__(self, bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool,
                 device, traffic_overrides: Optional[Dict] = None,
                 config_overrides: Optional[Dict] = None):
        self.cell = cells.cell(bench, cell_name)
        self.chips = self.cell["chips"]
        self.cfg = {**cells.config(bench, self.cell["config"]), **(config_overrides or {})}
        self.traffic = {**cells.traffic(self.cell["traffic"]), **(traffic_overrides or {})}
        self.limits = cells.limits(cell_name)
        self.task = cells.task(self.traffic["task"])
        self.seed = seed
        self.seconds = seconds
        self.tracing = trace
        self.device = device
        self.windows = len(window_starts(self.cfg["image_columns"], self.cfg["window"],
                                         self.cfg["jump"]))
        self.spans = Spans()
        self.control = False
        self.info: Dict = {}
        self.e2e: Dict[str, float] = {}
        self.window_start: Optional[float] = None
        self.attempted = 0
        self.failed = 0
        self.trace: Optional[Dict] = None
        self.slice_batches = 0
        self.slicer: Optional[slices.Slicer] = None
        self.memory_peak_bytes = 0

    def submitting(self, now: float) -> None:
        """The window's loop is about to submit a batch at host time ``now``."""
        if self.slicer is not None:
            self.slicer.before_submit(now)

    def expect_kernels(self, engaged: str) -> None:
        """Refuse a run whose program engaged another kernel family than the
        configuration's route (on the CPU: the plain versions)."""
        want = f"cuda_{self.cfg['route']}" if self.device.type == "cuda" else "torch"
        if engaged != want:
            raise RuntimeError(f"the program engaged {engaged!r}; {self.cell['config']} "
                               f"runs {want!r}")


def measure(run: Run, loop, rate: str) -> None:
    """The measured window. ``loop(seconds)`` submits batches, calling
    ``run.submitting`` before each, until ``seconds`` have passed since its
    first submission, drains them and returns (batches, first submission's
    time, last read's time). The window is one loop of ``run.seconds``,
    whose batches' windows over its time are ``run.e2e[rate]``. Traced, the
    profiler slice opens ``PRE_SLICE`` into it and covers ``TRACE_SECONDS``
    of submissions, with the pipeline full (:class:`trace.Slicer`)."""
    if run.tracing:
        slices.warm(run.device)
        run.slicer = slices.Slicer(run.spans, PRE_SLICE * run.seconds, TRACE_SECONDS)
    n, t0, t1 = loop(run.seconds)
    run.e2e[rate] = n * run.traffic["batch"] * run.windows / (t1 - t0)
    run.window_start, run.attempted = t0, n
    if run.tracing:
        run.trace = run.slicer.summary(run.chips)
        run.slice_batches = run.slicer.batches
        run.trace["host"] = (run.slicer.opened, run.slicer.shut)
        run.slicer = None


def _window_log(run: Run) -> str:
    """Each span's count, the median, least and most host seconds between
    the starts of successive ones over the window, and, traced, its mean
    length before, in and after the profiler slice."""
    starts: Dict[str, list] = {}
    for name, a, b in run.spans.records:
        if a >= run.window_start:
            starts.setdefault(name, []).append((a, b))
    opened, shut = (run.trace or {}).get("host", (None, None))
    parts = []
    for name, ab in sorted(starts.items()):
        d = sorted(b[0] - a[0] for a, b in zip(ab, ab[1:]))
        if not d:
            continue
        part = (f"{name} {len(ab)} x, every {1e3 * d[len(d) // 2]:.3f} ms "
                f"({1e3 * d[0]:.3f}-{1e3 * d[-1]:.3f})")
        if opened is not None and shut is not None:
            phases = ([b - a for a, b in ab if a < opened],
                      [b - a for a, b in ab if opened <= a < shut],
                      [b - a for a, b in ab if a >= shut])
            part += ", long " + " / ".join(f"{1e3 * sum(p) / len(p):.3f}" if p else "-"
                                           for p in phases) + " ms before / in / after the slice"
        parts.append(part)
    return "; ".join(parts)


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device, process_start: float, traffic_overrides: Optional[Dict] = None,
             config_overrides: Optional[Dict] = None, log=print) -> Tuple[Dict, Run]:
    """Run the cell; returns the result line's object and the run. The
    overrides shrink a cell for the CPU tests; the benchmark's runs pass none."""
    import torch

    run = Run(bench, cell_name, seed, seconds, trace, device, traffic_overrides,
              config_overrides)
    if device.type == "cuda":
        from helen_tpu_torch.ops.gru_window import get_lib

        log(f"card: {card_label()}; {torch.cuda.get_device_name(device)}; "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        t0 = time.perf_counter()
        get_lib()
        log(f"kernel library: {time.perf_counter() - t0:.3f} s to build or load")
        for i in range(run.chips):
            torch.cuda.reset_peak_memory_stats(i)
    state = run.task.setup(run)
    run.task.window(run, state)
    setup_s = run.window_start - process_start
    log(f"window: {run.e2e}; {_window_log(run)}")
    if run.trace is not None:
        log(f"slice: {run.slice_batches} batches, {run.trace['window_s']:.6f} s, busy "
            f"{run.trace['busy_s']:.6f} s, {run.trace['outside']} device events "
            "launched before it")
    peak = run.memory_peak_bytes
    if device.type == "cuda":
        peak = max([peak] + [torch.cuda.max_memory_allocated(i) for i in range(run.chips)])
    numbers = run.task.check(run, state)
    del state
    correct, compared = compare.verdict(numbers, run.limits)
    correct = correct and run.failed == 0
    if trace:
        metrics = {}
        for m in cells.metrics_of(bench, cell_name, "per_layer"):
            value = cells.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**run.e2e, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cells.metrics_of(bench, cell_name, "end_to_end")}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": {
                  "platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                  "count": run.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    log(f"checked: {run.info}")
    result["compared"] = compared
    return result, run
