"""Observability: structured logging, stage timers, throughput counters.

The reference has only ANSI-colored stderr prints and ad-hoc elapsed-time
strings (reference PolishInterface.py:33-46, predict_gpu.py:163-173). Here
observability is a first-class subsystem: a structured logger, context-manager
stage timers that aggregate into a report, throughput (windows/s) counters and
an optional torch.profiler trace hook, and the program's spans (obs.timing.span),
recorded while a profiler session or ``tracing()`` is on.
"""
from helen_tpu_torch.obs.logging import get_logger, log
from helen_tpu_torch.obs.timing import (
    RECORDER,
    StageTimer,
    Throughput,
    card_label,
    profile_trace,
    span,
    tracing,
)

__all__ = ["get_logger", "log", "RECORDER", "StageTimer", "Throughput", "card_label",
           "profile_trace", "span", "tracing"]
