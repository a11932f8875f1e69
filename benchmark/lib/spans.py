"""The benchmark's spans around its calls into the program's layers.

A span is (name, start, end) on the host's ``perf_counter``, kept in memory.
While a profiler slice is open each span is also a ``record_function``
range, so that the trace names the host's work beside the device's.
"""
from __future__ import annotations

import contextlib
import time
from statistics import fmean
from typing import Iterator, List, Optional, Tuple


class Spans:
    def __init__(self) -> None:
        self.records: List[Tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        if self.profiling:
            from torch.profiler import record_function

            with record_function(name):
                yield
        else:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def mean_ms(self, name: str) -> Optional[float]:
        """Mean length of the spans called ``name``, or None if there are none."""
        lengths = [t1 - t0 for n, t0, t1 in self.records if n == name]
        return 1e3 * fmean(lengths) if lengths else None
