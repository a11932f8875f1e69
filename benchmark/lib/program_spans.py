"""The program's own spans (``helen_tpu_torch.obs.timing``), read for the
per-layer metrics of a traced run.

While the profiler slice is open the program records a span at each of its
layer boundaries: name, start and end on ``perf_counter`` (the clock of the
slice's bounds, ``run.trace["host"]``), thread and parent. A metric here is
the mean, over the root spans of one name that begin and end inside the
slice (one per batch), of the summed lengths of their descendants of the
given names. A program without the recorder, or an untraced run, gives None.
"""
from __future__ import annotations

from typing import Iterable, Optional


def per_batch_ms(run, root: str, parts: Iterable[str]) -> Optional[float]:
    """Mean ms per ``root`` span inside the slice of its descendants, at any
    depth, named in ``parts``, or None where the slice holds no ``root`` span."""
    if run.trace is None or "host" not in run.trace:
        return None
    try:
        from helen_tpu_torch.obs.timing import RECORDER
    except ImportError:
        return None
    recs = RECORDER.records()
    opened, shut = run.trace["host"]
    roots = {r.id for r in recs if r.name == root and opened <= r.start and r.end <= shut}
    if not roots:
        return None
    parent = {r.id: r.parent for r in recs}
    parts = set(parts)
    total = 0.0
    for r in recs:
        if r.name not in parts:
            continue
        up = r.parent
        while up and up not in roots:
            up = parent.get(up, 0)
        if up:
            total += r.end - r.start
    return 1e3 * total / len(roots)
