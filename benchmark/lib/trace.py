"""The profiler slice of a ``--trace 1`` run, and what is read from it.

The window of a traced run is one continuous loop, as in an untraced run.
Before each submission the loop asks the :class:`Slicer`, which opens
``torch.profiler`` (host and device activity) at the first submission
``start_after`` seconds into the window and closes it at the first one
``length`` seconds after that, while the pipeline stays full: nothing is
drained before the slice or inside it. Closing the profiler waits for the
device, so every batch submitted in the slice finishes in its trace.

The slice's device work is what the host launched inside it: the device
events whose correlation id belongs to a runtime or driver call made while
the slice was open. The trace holds no kernel launched before the slice, so
the slice runs from the first kernel launched in it (which starts once the
stream has run what was queued before) to the end of the last of its
events; a copy launched in it that runs beside the earlier, unseen kernels
does not open it. Its busy time is the union of every device event
(kernels, copies, memsets) inside that stretch. Nothing falls back to a
host clock: a slice with no device events raises.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.lib.spans import Spans

#: the range around the slice's submissions, the trace's categories of
#: device work and of the host calls that launch it
SLICE = "benchmark_slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm(device) -> None:
    """Start and stop the profiler once on a trivial launch, so that the
    slice does not pay for loading the device tracer."""
    import torch

    with _profile():
        torch.ones(1, device=device).add_(1.0)
        torch.cuda.synchronize(device)


class Slicer:
    """Opens and closes the profiler between two submissions of a window."""

    def __init__(self, spans: Spans, start_after: float, length: float) -> None:
        self.spans, self.start_after, self.length = spans, start_after, length
        self.first: Optional[float] = None
        self.opened: Optional[float] = None
        self.shut: Optional[float] = None
        self.batches = 0
        self.prof = None
        self._range = None
        self.closed = False

    def before_submit(self, now: float) -> None:
        """Called by the window's loop before each submission at host time
        ``now``; counts the submissions made while the slice is open."""
        if self.closed:
            return
        if self.first is None:
            self.first = now
        if self.prof is None:
            if now - self.first < self.start_after:
                return
            from torch.profiler import record_function

            self.prof = _profile()
            self.prof.start()
            self.spans.profiling = True
            self._range = record_function(SLICE)
            self._range.__enter__()
            self.opened = now
        elif now - self.opened >= self.length:
            self.close()
            return
        self.batches += 1

    def close(self) -> None:
        if self.prof is None or self.closed:
            return
        self._range.__exit__(None, None, None)
        self.spans.profiling = False
        self.shut = time.perf_counter()
        self.prof.stop()
        self.closed = True

    def summary(self, chips: int) -> Dict:
        """:func:`summarize` of the closed slice's trace."""
        if self.prof is None:
            raise RuntimeError("the window ended before its profiler slice opened")
        self.close()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        if isinstance(events, dict):
            events = events["traceEvents"]
        return summarize(events, {n for n, _, _ in self.spans.records}, chips)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _span(e: Dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def summarize(events: List[Dict], span_names, chips: int = 1) -> Dict:
    """From chrome-trace events (times in microseconds): the slice's length
    ``window_s``, from its first launched kernel to the end of its last
    launched event; ``busy_s``, the union of the device events' intervals
    in it, per device, averaged over ``chips``; ``kernel_s``, the sum of the kernels'
    lengths in it; the device operations that took most time; the longest
    idle gaps of the card, each named by the benchmark span open on the host
    when it began (the slice's own thread first), or ``host`` where none
    was; ``outside``, the device events in the stretch that were launched
    before the slice."""
    slices = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    if not slices:
        raise RuntimeError(f"the trace holds no {SLICE!r} range")
    sl = slices[0]
    s0, s1 = _span(sl)
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in LAUNCH_CATS and e.get("ph") == "X"
                and "correlation" in e.get("args", {}) and s0 <= float(e["ts"]) <= s1}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    own = [e for e in device if e.get("args", {}).get("correlation") in launched]
    if not any(e["cat"] == "kernel" for e in own):
        raise RuntimeError("the trace holds no device events launched in the slice: "
                           "the profiler did not trace the card")
    t0 = min(_span(e)[0] for e in own if e["cat"] == "kernel")
    t1 = max(_span(e)[1] for e in own)
    inside = []
    for e in device:
        a, b = _span(e)
        a, b = max(t0, a), min(t1, b)
        if b > a:
            inside.append((a, b, e["name"], e["cat"], e.get("args", {}).get("device", 0),
                           e.get("args", {}).get("correlation") in launched))
    per_device: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for a, b, _, _, dev, _ in inside:
        per_device[dev].append((a, b))
    busy = sum(b - a for iv in per_device.values() for a, b in _union(iv)) / max(chips, 1)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name, _, _, _ in inside:
        by_name[name] += b - a
    host = [(*_span(e), e["name"], e.get("tid")) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e.get("name") in span_names]
    edges = [t0] + [x for ab in _union([(a, b) for a, b, *_ in inside]) for x in ab] + [t1]
    longest = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                     key=lambda g: g[0] - g[1])[:TOP]
    gaps = []
    for a, b in longest:
        open_ = [(tid != sl.get("tid"), name) for s, e, name, tid in host if s <= a < e]
        gaps.append((min(open_)[1] if open_ else "host", (b - a) * 1e-6))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy * 1e-6,
        "kernel_s": sum(b - a for a, b, _, cat, _, _ in inside if cat == "kernel") * 1e-6,
        "device_ops": [[name[:120], s * 1e-6] for name, s in ops],
        "idle_gaps": [[name, s] for name, s in gaps],
        "outside": sum(1 for *_, mine in inside if not mine),
    }
