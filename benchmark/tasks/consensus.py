"""Consensus traffic: batches of images through ``ConsensusStep`` as
``call_consensus`` drives it (``helen_tpu_torch/infer/consensus.py``).

A prefetch thread (the program's ``io.images.prefetched``) runs
``transfer`` (pinned memory, a side stream) for the next batch while the
main thread runs ``submit`` (the 19 windows, the vote, the packed label
readback, enqueued) and, ``pipeline_depth`` batches behind, ``read``. The
images come from a host pool of ``pool_batches`` distinct batches made from
the seed, cycled. Traffic parameters: ``batch``, ``pool_batches``,
``pipeline_depth``, ``warmup_batches``, ``check_rows``.

``correct``: of each pool batch, one read-back drawn from the seed among
those of the window (a reservoir of one), and of it ``check_rows`` images
drawn from the seed; the reference's votes for those images; the widest gap
by which the reference's vote for a served label lies below its best
(``vote_gap``).
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.lib import compare, data, harness
from benchmark.lib.spans import Spans
from benchmark.reference import transducer as ref


def setup(run):
    from helen_tpu_torch.infer.consensus import ConsensusStep

    cfg, tr = run.cfg, run.traffic
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    weights = data.make_params(cfg, gen, run.device)
    images, _, _ = data.make_images(cfg, tr, gen, run.device, tr["pool_batches"])
    # the program loads its weights from host memory, as from a checkpoint
    step = ConsensusStep(data.tree_to(weights, "cpu"), run.device)
    run.expect_kernels(step.kernels)
    n = len(images)
    st = SimpleNamespace(weights=weights, images=images, step=step, next=0,
                         seen=[0] * n, kept=[None] * n, rng=random.Random(run.seed))
    _loop(run, st, Spans(), batches=tr["warmup_batches"], keep=False)
    return st


def _loop(run, st, spans: Spans, seconds=None, batches=None, keep=True):
    """Submit batches, cycling the pool, until ``seconds`` have passed since
    the first submission or ``batches`` were submitted, then drain. Returns
    (batches submitted, time of the first submission, time of the last
    read)."""
    from helen_tpu_torch.io.images import prefetched

    step, depth, n = st.step, run.traffic["pipeline_depth"], len(st.images)

    def transferred():
        for i in itertools.count(st.next):
            with spans.span("transfer"):
                dev = step.transfer(st.images[i % n])
            yield i % n, dev

    def drain():
        k, handle = in_flight.popleft()
        with spans.span("read"):
            labels = step.read(handle)
        if keep:
            st.seen[k] += 1
            if st.rng.random() * st.seen[k] < 1.0:
                st.kept[k] = labels

    in_flight: deque = deque()
    submitted, first = 0, None
    items = prefetched(transferred, threading.Event(), depth)
    try:
        for k, dev in items:
            now = time.perf_counter()
            if first is None:
                first = now
            elif seconds is not None and now - first >= seconds:
                break
            run.submitting(now)
            with spans.span("submit"):
                in_flight.append((k, step.submit(dev)))
            submitted += 1
            if len(in_flight) > depth:
                drain()
            if batches is not None and submitted >= batches:
                break
    finally:
        items.close()
    while in_flight:
        drain()
    st.next += submitted
    return submitted, first, time.perf_counter()


def window(run, st) -> None:
    harness.measure(run, lambda s: _loop(run, st, run.spans, seconds=s),
                    "consensus_windows_per_s")


def _checked(run, st):
    """The images checked and the labels served for them."""
    rows = run.traffic["check_rows"]
    images, base, rle = [], [], []
    for k, kept in enumerate(st.kept):
        if kept is None:
            continue
        pick = np.sort(np.random.default_rng([run.seed, k]).choice(
            run.traffic["batch"], rows, replace=False))
        images.append(st.images[k][pick])
        base.append(kept[0][pick])
        rle.append(kept[1][pick])
    if not images:
        raise RuntimeError("no batch was read back in the window")
    cat = lambda a: torch.from_numpy(np.concatenate(a)).to(run.device)  # noqa: E731
    return cat(images), cat(base), cat(rle)


def check(run, st):
    images, base, rle = _checked(run, st)
    st.step = None  # the program's weights and buffers go before the reference runs
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref.fp32_only()
    cfg = run.cfg
    votes = ref.consensus_votes(st.weights, images, cfg["window"], cfg["jump"], "fp32")
    gap, flips = compare.vote_gap(votes, (base, rle))
    run.info.update(images_checked=int(images.shape[0]), labels_checked=2 * base.numel(),
                    flips=flips, read_backs=sum(st.seen))
    if run.control:
        low = ref.consensus_votes(st.weights, images, cfg["window"], cfg["jump"], "tf32")
        c_gap, c_flips = compare.vote_gap(votes, [v.argmax(dim=-1) for v in low])
        run.control_numbers = {"vote_gap": c_gap}
        run.info.update(control_flips=c_flips)
    return {"vote_gap": gap}
