"""The benchmark's readers of the program's spans (``benchmark/metrics/``
whose source is ``program_span``), on synthetic runs: each is the mean per
batch, in ms, of its parts' spans under the root spans that begin and end
inside the profiler slice; spans outside the slice, or under other roots,
do not count; an untraced run, a slice without a root, or a program
without the recorder gives None. Their ``BENCHMARK.json`` entries keep the
benchmark's rules of names, units and keys."""
import os
import re
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.lib import cells  # noqa: E402

#: each reader: its root span and the spans it sums under it
READERS = {
    "consensus.windows_ms": ("consensus.submit", ["consensus.window"]),
    "consensus.readback_ms": ("consensus.submit", ["consensus.vote", "consensus.readback"]),
    "consensus.read_wait_ms": ("consensus.read", ["consensus.read.wait"]),
    "consensus.pin_ms": ("consensus.transfer", ["consensus.transfer.pin"]),
    "train.forward_ms": ("train.step", ["train.forward", "train.loss"]),
    "train.backward_ms": ("train.step", ["train.backward"]),
    "train.adam_ms": ("train.step", ["train.adam"]),
}
SLICE = (100.0, 102.0)


def synthetic(root, parts):
    """Root spans before, inside (two), across the end of and after the
    slice; under each, every part once at depth 1 and once more under a
    span of another name, and a long span of another name. The parts of
    the first inside root last 1 + 3 ms each, of the second 2 + 5 ms."""
    from helen_tpu_torch.obs.timing import SpanRecord

    recs, ids = [], iter(range(1, 10 ** 6))

    def add(name, parent, start, length, tid=1):
        rid = next(ids)
        recs.append(SpanRecord(rid, parent, name, tid, start, start + length, {}))
        return rid

    for start, (a, b) in ((99.0, (50e-3, 50e-3)), (100.2, (1e-3, 3e-3)),
                          (101.0, (2e-3, 5e-3)), (101.9, (50e-3, 50e-3)),
                          (102.5, (50e-3, 50e-3))):
        r = add(root, 0, start, 0.2)
        inner = add("other", r, start + 0.05, 0.1)
        for p in parts:
            add(p, r, start + 0.01, a)
            add(p, inner, start + 0.06, b)
    # the same parts under no root, and on another thread under another root
    for p in parts:
        add(p, 0, 100.5, 1.0)
        add(p, add("elsewhere", 0, 100.6, 0.3, tid=2), 100.7, 0.1, tid=2)
    return recs


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_is_the_mean_per_batch_of_its_parts_inside_the_slice(metric, monkeypatch):
    from helen_tpu_torch.obs import timing

    root, parts = READERS[metric]
    recs = synthetic(root, parts)
    monkeypatch.setattr(timing.RECORDER, "records", lambda since=None: list(recs))
    read = cells.metric_reader(metric)
    value = read(SimpleNamespace(trace={"host": SLICE}))
    want = len(parts) * ((1.0 + 3.0) + (2.0 + 5.0)) / 2
    assert value == pytest.approx(want, rel=1e-9)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(SimpleNamespace(trace={"host": (200.0, 202.0)})) is None
    monkeypatch.setattr(timing.RECORDER, "records", lambda since=None: [])
    assert read(SimpleNamespace(trace={"host": SLICE})) is None


def test_readers_give_none_for_a_program_without_the_recorder(monkeypatch):
    """The parent program has ``obs.timing`` but no ``RECORDER``."""
    from helen_tpu_torch.obs import timing

    monkeypatch.delattr(timing, "RECORDER")
    for metric in READERS:
        assert cells.metric_reader(metric)(SimpleNamespace(trace={"host": SLICE})) is None


def test_span_metrics_keep_the_benchmarks_rules():
    bench = cells.load_benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cell_names = [w["name"] for w in bench["workloads"]]
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in READERS:
        m = entries[metric]
        assert name.match(m["name"]) and m["unit"] == "ms" and m["better"] == "lower"
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] == "program_span" and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cell_names))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{metric}.py"))
