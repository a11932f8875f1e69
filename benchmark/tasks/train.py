"""Training traffic: TBPTT batches through ``tbptt_step`` with ``Adam``, as
``Trainer.train_one_epoch`` drives them (``helen_tpu_torch/train/train_loop.py``).

Each batch is copied from a host pool of ``pool_batches`` distinct seeded
batches (images and truth labels) to the device, runs one ``tbptt_step``
(19 windows, each a forward, a backward and an Adam update, lr ``lr``) and
ends with ``float(tot)``, the loss read back. Traffic parameters: ``batch``,
``pool_batches``, ``lr``, ``checked_steps``.

``correct``: set-up makes one training object (the weights, Adam's state)
and drives it through its first ``checked_steps`` batches, the pool's first,
through the window's own call and feed; the same object then runs the
window. The reference follows those batches from the same weights. Compared:
each batch's loss (``loss_gap``, relative); the norm of Adam's first moment
after the first batch, leaf by leaf (``grad_gap``); and the norm of each
leaf's change after the checked batches (``change_gap``), both against the
larger of the reference's norm of that leaf and of the median leaf, over
the leaves whose reference gradient is not nought to rounding.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from benchmark.lib import compare, data, harness
from benchmark.lib.spans import Spans
from benchmark.reference import transducer as ref


def setup(run):
    from helen_tpu_torch.models.transducer import (
        engaged_kernel,
        param_leaves,
        resolve_backend,
        set_fp32_precision,
    )
    from helen_tpu_torch.train.train_loop import Adam

    cfg, tr = run.cfg, run.traffic
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    weights = data.make_params(cfg, gen, run.device)
    pool = data.make_images(cfg, tr, gen, run.device, tr["pool_batches"])
    set_fp32_precision()
    params = data.tree_to(weights, run.device)
    backend = resolve_backend(None, run.device, params, kind="train")
    run.expect_kernels(engaged_kernel(params, backend))
    for p in param_leaves(params):
        p.requires_grad_(True)
    adam = Adam()
    st = SimpleNamespace(weights=weights, pool=pool, params=params, adam=adam,
                         opt=adam.init(params), backend=backend, next=0, losses=[])
    for i in range(tr["checked_steps"]):
        st.losses.append(_step(run, st, Spans()))
        if i == 0:
            st.first_moment = [m.detach().clone() for m in param_leaves(st.opt["mu"])]
    st.after = [p.detach().clone() for p in param_leaves(params)]
    return st


def _step(run, st, spans: Spans) -> float:
    from helen_tpu_torch.train import train_loop

    images, label_base, label_rle = (a[st.next % len(a)] for a in st.pool)
    st.next += 1
    to_dev = lambda a: torch.from_numpy(a).to(run.device)  # noqa: E731
    with spans.span("tbptt_step"):
        tot, _, _ = train_loop.tbptt_step(
            st.params, st.adam, st.opt, run.traffic["lr"], to_dev(images),
            to_dev(label_base).long(), to_dev(label_rle).long(), run.traffic["batch"],
            st.backend)
    with spans.span("loss_read"):
        return float(tot)


def _loop(run, st, seconds: float):
    """TBPTT batches until ``seconds`` have passed since the first began;
    returns (batches, their start, the last loss's read)."""
    first, n = time.perf_counter(), 0
    while n == 0 or time.perf_counter() - first < seconds:
        run.submitting(time.perf_counter())
        if not math.isfinite(_step(run, st, run.spans)):
            run.failed += 1
        n += 1
    return n, first, time.perf_counter()


def window(run, st) -> None:
    harness.measure(run, lambda s: _loop(run, st, s), "train_windows_per_s")


def _reference(run, st, precision: str):
    """The reference's losses, first moment after the first batch and
    leaves after the checked batches, from the benchmark's weights."""
    cfg = run.cfg
    params = data.tree_to(st.weights, run.device)
    adam = ref.Adam(ref.leaves(params), run.traffic["lr"])
    losses, first_moment = [], None
    for i in range(run.traffic["checked_steps"]):
        images, label_base, label_rle = (torch.from_numpy(a[i]).to(run.device)
                                         for a in st.pool)
        losses.append(ref.tbptt_batch(params, adam, images, label_base, label_rle,
                                      cfg["window"], cfg["jump"], precision))
        if i == 0:
            first_moment = [m.clone() for m in adam.mu]
    return losses, first_moment, ref.leaves(params)


def _numbers(losses, first_moment, after, initial, ref_run):
    r_losses, r_first, r_after = ref_run
    counted = compare.counted_leaves(r_first)
    return {
        "loss_gap": compare.relative_gap(losses, r_losses),
        "grad_gap": compare.leaf_norm_gap(first_moment, r_first, counted),
        "change_gap": compare.leaf_norm_gap([a - w for a, w in zip(after, initial)],
                                            [a - w for a, w in zip(r_after, initial)],
                                            counted),
    }


def check(run, st):
    st.params = st.opt = st.adam = None  # the program's state goes first
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    ref.fp32_only()
    initial = ref.leaves(st.weights)
    ref_run = _reference(run, st, "fp32")
    run.info.update(losses=st.losses, ref_losses=ref_run[0],
                    leaves_counted=sum(compare.counted_leaves(ref_run[1])),
                    leaves=len(initial))
    if run.control:
        low = _reference(run, st, "tf32")
        run.control_numbers = _numbers(low[0], low[1], low[2], initial, ref_run)
    return _numbers(st.losses, st.first_moment, st.after, initial, ref_run)
