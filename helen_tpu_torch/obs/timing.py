"""Stage timers and throughput counters.

First-class replacement for the reference's inline elapsed-time arithmetic
(reference PolishInterface.py:98-105, predict_gpu.py:163-173).
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class StageTimer:
    """Accumulates wall-clock per named stage; renders a summary table."""

    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
    of the enclosed block into ``log_dir/trace.json`` (CLI: --profile_dir).
    The trace opens in chrome://tracing or Perfetto."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
