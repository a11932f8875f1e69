"""Stage timers, throughput counters and the program's spans.

First-class replacement for the reference's inline elapsed-time arithmetic
(reference PolishInterface.py:98-105, predict_gpu.py:163-173).

Spans: ``with span("consensus.submit", batch=n):`` at a layer boundary
records, while tracing is on, the name, start and end on ``time.perf_counter``,
the thread, the span open on the same thread (its parent) and the integer
counts the call site passes, in the process's :data:`RECORDER`, in memory.
Tracing is on while a ``torch.profiler`` session records, or inside
:func:`tracing`. Off, ``span`` returns a shared object that does nothing.
A clock anchor (:meth:`Recorder.anchor`, which :func:`profile_trace` opens)
lets :func:`merge_into_trace` place every thread's spans on the profiler's
timeline. No span synchronises with a device or launches work on one.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional

from helen_tpu_torch.obs.logging import get_logger


class SpanRecord(NamedTuple):
    """One finished span: ``parent`` is the ``id`` of the span that was open
    on the same thread when it began (0: none); ``tid`` the thread's native
    id, as the profiler's trace gives it; times in ``perf_counter`` seconds."""

    id: int
    parent: int
    name: str
    tid: int
    start: float
    end: float
    counts: Dict[str, int]


#: the records a process keeps; the rest are counted in ``Recorder.dropped``
LIMIT = 1 << 18


def _profiler_on() -> bool:
    """Whether a ``torch.profiler`` session records; False until torch is
    imported (the package's light modules import this one without torch)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


#: what :func:`span` returns while tracing is off
NO_SPAN = _NoSpan()


class Recorder:
    """The spans of one process, kept in memory: at most :data:`LIMIT`
    records, the rest counted in ``dropped``. ``anchors`` holds each clock
    anchor as (its range's name, ``perf_counter`` just before the range
    opened)."""

    def __init__(self) -> None:
        self.forced = 0
        #: each recording thread's name, by native id
        self.threads: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._anchor_ids = itertools.count()
        self._local = threading.local()
        self.clear()

    def clear(self) -> None:
        """Drop every record and anchor."""
        self._records: List[SpanRecord] = []
        self.anchors: List[tuple] = []
        self.dropped = 0

    def records(self) -> List[SpanRecord]:
        """The finished spans."""
        return list(self._records)

    def anchor(self) -> None:
        """Open and close one ``record_function`` range on this thread, named
        ``obs.clock.<n>``, noting ``perf_counter`` just before it opens: the
        trace's ``ts`` of that range then gives the offset from
        ``perf_counter`` to the profiler's timeline. Call it while the
        profiler records, before the spans it is to place."""
        from torch.profiler import record_function

        name = f"obs.clock.{next(self._anchor_ids)}"
        with record_function("obs.clock.warm"):  # the range's first call is slow
            pass
        t = time.perf_counter()
        with record_function(name):
            pass
        self.anchors.append((name, t))

    def _thread(self) -> threading.local:
        """This thread's open spans (``stack``) and native id (``tid``)."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
            self.threads[local.tid] = threading.current_thread().name
        return local

    def _add(self, rec: SpanRecord) -> None:
        if len(self._records) < LIMIT:
            self._records.append(rec)
        else:
            with self._lock:
                self.dropped += 1


#: the process's recorder
RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "start", "thread")

    def __init__(self, name: str, counts: Dict[str, int]) -> None:
        self.name, self.counts = name, counts

    def __enter__(self) -> "_Span":
        thread = self.thread = RECORDER._thread()
        stack = thread.stack
        self.parent = stack[-1].id if stack else 0
        self.id = next(RECORDER._ids)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        self.thread.stack.pop()
        RECORDER._add(SpanRecord(self.id, self.parent, self.name, self.thread.tid,
                                 self.start, end, self.counts))


def span(name: str, **counts: int):
    """A context manager around one layer's work: records a :class:`SpanRecord`
    while tracing is on (a ``torch.profiler`` session, or :func:`tracing`),
    else returns :data:`NO_SPAN`. ``counts``: integers the caller measured
    (rows, bytes, a batch's sequence number)."""
    if not (RECORDER.forced or _profiler_on()):
        return NO_SPAN
    return _Span(name, counts)


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """Record spans inside the block without a profiler session (tests)."""
    with RECORDER._lock:
        RECORDER.forced += 1
    try:
        yield RECORDER
    finally:
        with RECORDER._lock:
            RECORDER.forced -= 1


def merge_into_trace(path: str, records: List[SpanRecord]) -> None:
    """Add ``records`` to the Chrome trace at ``path`` (``export_chrome_trace``'s
    file) as complete events of category ``program_span``, each on its own
    thread's ``tid``, with its counts, ``id`` and ``parent`` in ``args``, on
    the trace's clock: the offset from ``perf_counter`` comes from the last
    of :data:`RECORDER`'s clock anchors that the trace holds. The trace's
    ``programSpansDropped`` says how many spans past :data:`LIMIT` are
    missing; a warning says so too."""
    with open(path) as f:
        trace = json.load(f)
    trace["programSpansDropped"] = RECORDER.dropped
    if RECORDER.dropped:
        get_logger("timing").warning(
            "%s lacks %d program spans: the recorder keeps %d", path, RECORDER.dropped, LIMIT)
    events = trace["traceEvents"]
    ranges = {e.get("name"): e["ts"] for e in events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("obs.clock.")}
    found = [ranges[name] - t * 1e6 for name, t in RECORDER.anchors if name in ranges]
    if not found:
        raise ValueError(f"{path} holds no clock anchor of this process")
    offset = found[-1]
    pid = os.getpid()
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for tid in sorted({r.tid for r in records} - named):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": RECORDER.threads.get(tid, f"thread {tid}")}})
    for r in records:
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                       "tid": r.tid, "ts": r.start * 1e6 + offset,
                       "dur": (r.end - r.start) * 1e6,
                       "args": {**r.counts, "id": r.id, "parent": r.parent}})
    with open(path, "w") as f:
        json.dump(trace, f)


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage; renders a summary table. Each
    stage is also a :func:`span` of the same name."""

    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        if not self.stages:
            return "(no stages timed)"
        width = max(len(k) for k in self.stages)
        lines = []
        for name, total in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<{width}}  {total:10.3f}s  ({n} calls)")
        return "\n".join(lines)


@dataclass
class Throughput:
    """Running items/s counter (e.g. pileup windows per second)."""

    unit: str = "items"
    total: int = 0
    _t0: Optional[float] = None
    _elapsed: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            self._elapsed += time.perf_counter() - self._t0
            self._t0 = None

    def add(self, n: int) -> None:
        self.total += n

    @property
    def elapsed(self) -> float:
        extra = (time.perf_counter() - self._t0) if self._t0 is not None else 0.0
        return self._elapsed + extra

    @property
    def rate(self) -> float:
        e = self.elapsed
        return self.total / e if e > 0 else 0.0

    def __str__(self) -> str:
        return f"{self.total} {self.unit} in {self.elapsed:.2f}s = {self.rate:,.0f} {self.unit}/s"


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Optionally capture a torch.profiler trace (host and CUDA activity)
    of the enclosed block into ``log_dir/trace.json`` (CLI: --profile_dir),
    with the program's spans of every host thread merged in
    (:func:`merge_into_trace`). The trace opens in chrome://tracing or
    Perfetto."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    RECORDER.clear()
    with profile(activities=activities) as prof:
        RECORDER.anchor()
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    merge_into_trace(path, RECORDER.records())


def card_label() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a card
    may be set below its maximum, and runs slower under load then): the
    label every time measured on a card carries. None where nvidia-smi does
    not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None
