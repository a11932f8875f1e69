"""What is read from a profiler slice, on chrome-trace events made by hand."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.lib import trace  # noqa: E402
from benchmark.lib.spans import Spans  # noqa: E402


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr, "device": 0}
    return e


def test_summary_of_a_slice():
    events = [
        _x("user_annotation", trace.SLICE, 100.0, 1000.0),
        _x("user_annotation", "submit", 1000.0, 150.0),
        _x("user_annotation", "read", 600.0, 100.0),
        _x("cuda_runtime", "cudaLaunchKernel", 50.0, 5.0, corr=0),  # before the slice
        _x("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0, corr=1),
        _x("cuda_driver", "cuLaunchKernel", 200.0, 5.0, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 300.0, 5.0, tid=2, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1050.0, 5.0, corr=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 120.0, 5.0, tid=2, corr=5),
        _x("gpu_memcpy", "Memcpy HtoD", 160.0, 40.0, tid=9, corr=5),  # beside unseen kernels
        _x("kernel", "k0", 150.0, 150.0, tid=7, corr=0),  # still running as the slice opens
        _x("kernel", "k1", 250.0, 200.0, tid=7, corr=1),
        _x("kernel", "k2", 400.0, 250.0, tid=8, corr=2),  # overlaps k1 on another stream
        _x("gpu_memcpy", "Memcpy HtoD", 800.0, 100.0, tid=9, corr=3),
        _x("kernel", "k1", 1100.0, 100.0, tid=7, corr=4),  # launched in it, runs past it
        _x("cpu_op", "aten::mm", 0.0, 1000.0),
    ]
    s = trace.summarize(events, {"submit", "read"})
    # from the first kernel launched in the slice to the end of its last event
    assert s["window_s"] == pytest.approx(950e-6)
    # busy: [250, 650] + [800, 900] + [1100, 1200]; k0's tail lies inside k1
    assert s["busy_s"] == pytest.approx(600e-6)
    assert s["kernel_s"] == pytest.approx((50 + 200 + 250 + 100) * 1e-6)
    assert s["outside"] == 1
    assert s["device_ops"][0] == ["k1", pytest.approx(300e-6)]
    assert s["idle_gaps"] == [["host", pytest.approx(200e-6)], ["read", pytest.approx(150e-6)]]
    # on four chips the busy time is the mean of theirs
    assert trace.summarize(events, set(), chips=4)["busy_s"] == pytest.approx(150e-6)


def test_a_slice_without_device_events_fails():
    events = [_x("user_annotation", trace.SLICE, 0.0, 1000.0), _x("cpu_op", "aten::mm", 0, 5),
              _x("kernel", "k0", 10.0, 5.0, tid=7, corr=9)]  # launched before the slice
    with pytest.raises(RuntimeError, match="no device events"):
        trace.summarize(events, set())


def test_slicer_opens_and_closes_between_submissions():
    spans = Spans()
    slicer = trace.Slicer(spans, start_after=0.25, length=0.5)
    with pytest.raises(RuntimeError, match="before its profiler slice opened"):
        trace.Slicer(spans, 0.25, 0.5).summary(1)
    for now in (10.0, 10.125):
        slicer.before_submit(now)
    assert slicer.prof is None and slicer.batches == 0
    slicer.before_submit(10.25)
    assert spans.profiling and slicer.batches == 1
    with spans.span("submit"):
        pass
    slicer.before_submit(10.5)
    slicer.before_submit(10.75)  # the slice's length has passed: it closes here
    slicer.before_submit(10.875)
    assert slicer.closed and not spans.profiling and slicer.batches == 2
    # the CPU traces no device: the slice holds no device events
    with pytest.raises(RuntimeError, match="no device events"):
        slicer.summary(1)


def test_spans_mean():
    spans = Spans()
    spans.records += [("submit", 0.0, 0.002), ("submit", 1.0, 1.004), ("read", 0.0, 1.0)]
    assert spans.mean_ms("submit") == pytest.approx(3.0)
    assert spans.mean_ms("transfer") is None
