"""The program's spans (``helen_tpu_torch.obs.timing``) on the CPU.

Off, ``span`` hands back one shared object and records, allocates and calls
nothing; on (``tracing()``, or any ``torch.profiler`` session) the consensus
step and the TBPTT step record their layers as a tree with one ``batch`` id
per consensus batch; a profiler session turns spans on and off by itself,
and ``profile_trace`` merges every thread's spans into its ``trace.json`` on
the profiler's clock; ``StageTimer`` keeps its names and counts.
"""
import dataclasses
import json
import logging
import os
import threading
import tracemalloc
from collections import Counter

import numpy as np
import pytest
import torch

from torch_port_fixtures import golden, stage_golden_images

torch.set_num_threads(2)

WINDOWS = 19


@pytest.fixture(autouse=True)
def empty_recorder():
    from helen_tpu_torch.obs.timing import RECORDER

    RECORDER.clear()
    yield RECORDER
    RECORDER.clear()


def tiny_params(seed=0):
    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import flatten_tree, unflatten_tree
    from helen_tpu_torch.models.transducer import init_params

    cfg = dataclasses.replace(MODEL, hidden_size=8, gru_layers=1)
    return unflatten_tree(flatten_tree(init_params(torch.Generator().manual_seed(seed), cfg)))


def images(batch, seed=0):
    return np.random.default_rng(seed).integers(0, 9, (batch, 1000, 90), dtype=np.uint8)


def run_consensus(batches=2):
    """Two batches through transfer, submit and read, as call_consensus
    drives them (all transferred, then submitted, then read)."""
    from helen_tpu_torch.infer.consensus import ConsensusStep

    step = ConsensusStep(tiny_params(), "cpu")
    handles = [step.transfer(images(2, seed=b)) for b in range(batches)]
    submitted = [step.submit(h) for h in handles]
    return [step.read(s) for s in submitted]


def test_off_records_nothing_allocates_nothing_and_returns_the_shared_object(
        monkeypatch, empty_recorder):
    import torch.autograd.profiler as autograd_profiler
    import torch.profiler

    from helen_tpu_torch.obs.timing import NO_SPAN, span

    def refused(*args, **kwargs):
        raise AssertionError("record_function called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(autograd_profiler, "record_function", refused)
    def spans():
        # the protocol a with statement runs, called directly: the statement
        # itself also makes a bound ``__exit__``, whatever its manager
        s = span("consensus.window", k=3)
        s.__enter__()
        s.__exit__(None, None, None)
        s = span("train.step")
        s.__enter__()
        s.__exit__(None, None, None)

    assert span("consensus.window", k=3) is NO_SPAN and span("train.step") is NO_SPAN
    spans()  # warm: a first call may fill a cache
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        spans()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak == 0
    run_consensus()
    assert empty_recorder.records() == []


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def assert_tree(records):
    """Every parent is a recorded span on the same thread that holds its
    child's interval."""
    ids = {r.id: r for r in records}
    for r in records:
        if r.parent:
            p = ids[r.parent]
            assert p.tid == r.tid and p.start <= r.start <= r.end <= p.end, (r, p)


def test_consensus_step_records_its_layers_with_one_batch_id_a_batch(empty_recorder):
    from helen_tpu_torch.obs import tracing

    with tracing():
        run_consensus(batches=2)
    recs = empty_recorder.records()
    names = by_name(recs)
    assert Counter(r.name for r in recs) == {
        "consensus.transfer": 2, "consensus.submit": 2, "consensus.windows": 2,
        "consensus.window": 2 * WINDOWS, "consensus.vote": 2, "consensus.readback": 2,
        "consensus.read": 2, "consensus.read.decode": 2}
    assert_tree(recs)
    ids = {r.id: r for r in recs}
    for top in ("consensus.transfer", "consensus.submit", "consensus.read"):
        assert sorted(r.counts["batch"] for r in names[top]) == [0, 1]
        assert all(r.parent == 0 for r in names[top])
    assert all(r.counts == {"batch": r.counts["batch"], "rows": 2, "bytes": 2 * 1000 * 90}
               for r in names["consensus.transfer"])
    parent_of = lambda r: ids[r.parent].name  # noqa: E731
    for child, parent in (("consensus.windows", "consensus.submit"),
                          ("consensus.vote", "consensus.submit"),
                          ("consensus.readback", "consensus.submit"),
                          ("consensus.window", "consensus.windows"),
                          ("consensus.read.decode", "consensus.read")):
        assert {parent_of(r) for r in names[child]} == {parent}, child
    for windows in names["consensus.windows"]:
        ks = [r.counts["k"] for r in names["consensus.window"] if r.parent == windows.id]
        assert ks == list(range(WINDOWS))


@pytest.mark.parametrize("allsum", [None, "identity"])
def test_tbptt_step_records_each_windows_forward_loss_backward_and_adam(allsum,
                                                                       empty_recorder):
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.obs import tracing
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    tp = params_to_torch(tiny_params(), "cpu")
    for p in param_leaves(tp):
        p.requires_grad_(True)
    adam = Adam(1e-3)
    state = adam.init(tp)
    rng = np.random.default_rng(1)
    with tracing():
        tbptt_step(tp, adam, state, 1e-3, torch.from_numpy(images(2)),
                   torch.from_numpy(rng.integers(0, 5, (2, 1000))),
                   torch.from_numpy(rng.integers(0, 11, (2, 1000))), 2, "torch",
                   allsum=(lambda t: t) if allsum else None)
    recs = empty_recorder.records()
    names = by_name(recs)
    (step,) = names["train.step"]
    assert_tree(recs)
    assert Counter(r.name for r in recs) == {
        "train.step": 1, "train.forward": WINDOWS, "train.loss": WINDOWS,
        "train.backward": WINDOWS, "train.adam": WINDOWS}
    windows = sorted((r for r in recs if r.parent == step.id), key=lambda r: r.start)
    assert [r.name for r in windows] == WINDOWS * [
        "train.forward", "train.loss", "train.backward", "train.adam"]
    assert all(r.counts == {} for r in recs)


def test_a_profiler_session_turns_spans_on_and_profile_trace_merges_every_thread(
        tmp_path, empty_recorder):
    import torch.autograd.profiler as autograd_profiler

    from helen_tpu_torch.obs import profile_trace, span, tracing
    from helen_tpu_torch.obs.timing import NO_SPAN

    from torch.profiler import record_function

    side = {}

    def other():
        side["tid"] = threading.get_native_id()
        with span("side.work", k=7):
            torch.ones(64).sum()

    assert span("outer") is NO_SPAN
    with tracing():
        with span("before"):  # a record of an earlier session: profile_trace drops it
            pass
    with profile_trace(str(tmp_path)):
        assert autograd_profiler._is_profiler_enabled
        assert span("outer") is not NO_SPAN
        for i in range(5):
            # each span beside a range of its own name, opened just after it,
            # to hold the merged clock against the profiler's
            with span("outer", k=i), record_function("outer"):
                with span("inner"), record_function("inner"):
                    torch.ones(64).sum()
        t = threading.Thread(target=other, name="side")
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert span("outer") is NO_SPAN
    with span("after"):
        pass
    assert "after" not in {r.name for r in empty_recorder.records()}
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert trace["programSpansDropped"] == 0
    events = trace["traceEvents"]
    main = threading.get_native_id()
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    merged = [e for e in events if e.get("cat") == "program_span"]
    assert Counter(e["name"] for e in merged) == {"outer": 5, "inner": 5, "side.work": 1}
    for e in merged:
        if e["tid"] != main:
            continue
        own = min((r for r in ranges if r["name"] == e["name"] and r["tid"] == main),
                  key=lambda r: abs(r["ts"] - e["ts"]))
        assert abs(own["ts"] - e["ts"]) < 100.0, (e, own)
    (work,) = [e for e in merged if e["name"] == "side.work"]
    assert work["tid"] == side["tid"] != main and work["args"]["k"] == 7
    assert {"name": "side"} in [e["args"] for e in events
                                if e.get("ph") == "M" and e.get("tid") == side["tid"]]


def test_spans_past_the_limit_are_counted_and_the_merged_trace_says_so(
        tmp_path, monkeypatch, caplog, empty_recorder):
    from helen_tpu_torch.obs import profile_trace, span, timing

    monkeypatch.setattr(timing, "LIMIT", 3)
    logger = logging.getLogger("helen_tpu_torch.timing")  # the package's loggers do not propagate
    logger.addHandler(caplog.handler)
    try:
        with profile_trace(str(tmp_path)):
            for i in range(5):
                with span("outer", k=i):
                    pass
    finally:
        logger.removeHandler(caplog.handler)
    assert [r.counts["k"] for r in empty_recorder.records()] == [0, 1, 2]
    assert empty_recorder.dropped == 2
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert trace["programSpansDropped"] == 2
    assert sum(e.get("cat") == "program_span" for e in trace["traceEvents"]) == 3
    assert "lacks 2 program spans" in caplog.text


def test_stage_timer_keeps_its_stages_and_counts_through_call_consensus(tmp_path,
                                                                        empty_recorder):
    from helen_tpu_torch.infer.consensus import call_consensus
    from helen_tpu_torch.obs import StageTimer, tracing

    imgs = stage_golden_images(tmp_path / "images")

    def run(out):
        timer = StageTimer()
        call_consensus(image_dir=imgs, model_path=golden("golden_model.pkl"),
                       output_dir=str(tmp_path / out), batch_size=4, num_workers=2,
                       device="cpu", stage_timer=timer)
        return timer

    off = run("off")
    assert empty_recorder.records() == []
    with tracing():
        on = run("on")
    assert set(off.stages) == set(on.stages) == {
        "image_read", "device_transfer", "device_submit", "device_read", "write", "flush"}
    assert off.counts == on.counts and off.counts["device_submit"] == 3
    recorded = Counter(r.name for r in empty_recorder.records() if r.name in on.counts)
    assert recorded == on.counts
    assert "device_submit" in on.report()


@pytest.mark.cuda
def test_on_the_card_spans_name_the_copies_and_add_no_launch_or_wait(tmp_path, monkeypatch,
                                                                      empty_recorder):
    """One batch through the plain route on the card, traced with the spans
    off and on: the same launch and synchronisation calls of the runtime,
    and the copies' spans, which exist on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copies and their events exist only there")
    from torch.profiler import ProfilerActivity, profile

    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.obs import timing

    step = ConsensusStep(tiny_params(), torch.device("cuda"), backend="torch")
    batch = images(2)

    def traced(name):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step.read(step.submit(step.transfer(batch)))
        path = str(tmp_path / f"{name}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return Counter(e["name"] for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and ("Launch" in e["name"] or "Synchronize" in e["name"]))

    step.read(step.submit(step.transfer(batch)))  # warm: allocations, library loads
    with monkeypatch.context() as m:
        m.setattr(timing, "_profiler_on", lambda: False)
        off = traced("off")
        assert empty_recorder.records() == []
    on = traced("on")
    assert on == off and sum(on.values()) > 0
    names = Counter(r.name for r in empty_recorder.records())
    assert {n: names[n] for n in ("consensus.transfer.pin", "consensus.transfer.issue",
                                  "consensus.read.wait", "consensus.window")} == {
        "consensus.transfer.pin": 1, "consensus.transfer.issue": 1,
        "consensus.read.wait": 1, "consensus.window": WINDOWS}
