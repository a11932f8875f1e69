"""Sharding-overhead harness: sharded vs unsharded step at IDENTICAL total work.

Port of helen_tpu/tools/sharding_overhead.py. For each device count k it
times, from the same weights and the same data,

  * the UNSHARDED program: one process at global batch k*b,
  * the SHARDED program: k processes at b rows each, the same global
    batch; for training that includes the sums over the processes that
    ``train`` runs in a job, the loss denominators and then one flattened
    gradient buffer per window (``tbptt_step(...,
    allsum=multihost.allreduce_sum)``, as train.train_loop.Trainer calls
    it), and for consensus one exact sum of the labels at the end of each
    trial,

both in one job of k processes (parallel.multihost.run_task), process 0
running the unsharded program alone while the others wait, so that both
sides run in processes alike, started alike. Each side's time is the
minimum over 4 trials of ``steps`` back-to-back calls, after a
warm-up and outside each process's start-up. Total work is identical, so
``t_sharded / t_unsharded - 1`` is what sharding costs: the collectives,
and where a device list repeats a card (``["cuda:0", "cuda:0"]``, helen_tpu's
virtual CPU mesh in the CI, ``["cpu", "cpu"]``), its processes' sharing of
it. Training is the trainer's ``tbptt_step`` (gradient plus Adam) on the
default backend (the kernels on a card); consensus is ``consensus_labels``
on the plain route (``backend="torch"``, helen_tpu's ``"xla"`` here).

Usage:
  python -m helen_tpu_torch.tools.sharding_overhead [-b PER_DEVICE_BATCH]
      [--steps N] [--devices 2,4,8] [--image_len L]
      [--device_list cuda:0,cuda:0] [--json_out F]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from helen_tpu_torch.parallel import multihost
from helen_tpu_torch.tools.scaling_bench import write_json

#: the learning rate of the timed steps (helen_tpu's)
LR = 1e-4


def _time_steps(fn: Callable, steps: int, fence: Callable, reset: Callable,
                trials: int = 4):
    """MIN-of-trials wall time for ``steps`` back-to-back calls of ``fn``,
    and what ``fence`` reads of the warm-up call. ``reset`` restores the
    starting state before the warm-up and each trial, untimed, so every
    trial does the same work from the same weights.

    Min, not median: both sides of the overhead ratio run on the same
    shared cores or card, and scheduling noise only ever ADDS time, so the
    minimum is the estimator closest to the noise-free cost."""
    reset()
    first = fence(fn())  # warm-up
    times = []
    for _ in range(trials):
        reset()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = fn()
        fence(out)
        times.append(time.perf_counter() - t0)
    return min(times), first


def job_data(global_batch: int, image_len: int) -> Dict[str, np.ndarray]:
    """The global batch of both sides, from ``default_rng(0)``: training
    images and labels at ``image_len``, consensus images at 1000 columns."""
    rng = np.random.default_rng(0)
    B = global_batch
    return {"images": rng.integers(0, 40, size=(B, image_len, 90)).astype(np.uint8),
            "yb": rng.integers(0, 5, size=(B, image_len)).astype(np.int32),
            "yr": rng.integers(0, 11, size=(B, image_len)).astype(np.int32),
            "cim": rng.integers(0, 40, size=(B, 1000, 90)).astype(np.uint8)}


def _side(task: dict, device, parts: int, part: int) -> dict:
    """One process's share of one side: rows ``part`` of ``parts`` of the
    global batch (the whole batch, with no collective, for ``parts`` 1);
    the training step's and the consensus's min-of-trials seconds, the
    warm-up step's loss (a mean over the global batch) and the labels' sum
    (over the global batch)."""
    import torch

    from helen_tpu_torch import ops
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import (
        consensus_labels,
        engaged_kernel,
        init_params,
        param_leaves,
        resolve_backend,
    )
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    b = task["global_batch"] // parts
    data = job_data(task["global_batch"], task["image_len"])

    def rows(key):
        return torch.from_numpy(data[key][part * b:(part + 1) * b]).to(device)

    images, cim = rows("images"), rows("cim")
    yb, yr = rows("yb").long(), rows("yr").long()
    params = params_to_torch(init_params(torch.Generator().manual_seed(0)), device)
    leaves = param_leaves(params)
    start = [p.clone() for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
    backend = resolve_backend(None, device, params, kind="train")
    adam = Adam(0.0)
    state = {}
    allsum = multihost.allreduce_sum if parts > 1 else None

    def reset():
        with torch.no_grad():
            for p, p0 in zip(leaves, start):
                p.copy_(p0)
        state.update(adam.init(params))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def train():
        return tbptt_step(params, adam, state, LR, images, yb, yr, b, backend, allsum=allsum)

    ops.reset_launch_counts()
    t_train, loss = _time_steps(train, task["steps"], lambda out: float(out[0]), reset)
    launches = ops.launch_counts()

    def cons():
        with torch.no_grad():
            base, rle = consensus_labels(params, cim, backend="torch")
            return base.sum(dtype=torch.int64) + rle.sum(dtype=torch.int64)

    def cons_fence(out):
        total = np.array([int(out)])
        return int((multihost.allsum_hosts_exact(total) if parts > 1 else total)[0])

    t_cons, label_sum = _time_steps(cons, task["steps"], cons_fence, reset)
    return {"rank": part, "train_s": t_train, "consensus_s": t_cons, "loss": loss,
            "label_sum": label_sum, "launches": launches, "backend": backend,
            "kernel": engaged_kernel(params, backend)}


def _process(task: dict, device) -> dict:
    """One process of a count's job: process 0 runs the unsharded side
    alone while the others wait at a barrier, then every process its rows
    of the sharded side."""
    from helen_tpu_torch.models.transducer import set_fp32_precision

    set_fp32_precision()
    k, rank = multihost.process_count(), multihost.process_index()
    out = {"unsharded": _side(task, device, 1, 0) if rank == 0 else None}
    multihost.barrier("sharding-overhead-unsharded")
    out["sharded"] = _side(task, device, k, rank)
    return out


def measure(
    device_counts: Optional[Sequence[int]] = None,
    per_device_batch: int = 2,
    steps: int = 2,
    image_len: int = 200,
    devices: Optional[Sequence[str]] = None,
    records: Optional[Dict[int, dict]] = None,
    timeout_s: Optional[float] = None,
) -> List[dict]:
    """One row per device count k > 1 (default 2, 4, 8 up to the number of
    devices): a job of k processes on the first k devices (default: every
    visible GPU; a list may repeat one), process 0 timing the unsharded
    side alone, then all k the sharded side. ``records``, where given,
    gets each count's ``{"unsharded": [result], "sharded": [results]}``:
    per process its seconds, the warm-up step's loss, the labels' sum, the
    kernels' launches in training, the backend and the kernel family."""
    devices = multihost.job_devices(devices)
    if device_counts is None:
        device_counts = [k for k in (2, 4, 8) if k <= len(devices)]
    device_counts = sorted(k for k in device_counts if 1 < k <= len(devices))
    rows = []
    for k in device_counts:
        B = per_device_batch * k
        task = {"global_batch": B, "steps": steps, "image_len": image_len}
        procs = multihost.run_task(__name__, task, devices[:k], timeout_s)
        solo, shard = [procs[0]["unsharded"]], [p["sharded"] for p in procs]
        if records is not None:
            records[k] = {"unsharded": solo, "sharded": shard}
        t_train_solo, t_cons_solo = solo[0]["train_s"], solo[0]["consensus_s"]
        # the slowest process's
        t_train_shard = max(p["train_s"] for p in shard)
        t_cons_shard = max(p["consensus_s"] for p in shard)
        row = {
            "devices": k,
            "global_batch": B,
            "train_unsharded_s": round(t_train_solo, 4),
            "train_sharded_s": round(t_train_shard, 4),
            "train_overhead": round(t_train_shard / t_train_solo - 1, 4),
            "consensus_unsharded_s": round(t_cons_solo, 4),
            "consensus_sharded_s": round(t_cons_shard, 4),
            "consensus_overhead": round(t_cons_shard / t_cons_solo - 1, 4),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--task" in argv:  # a process of one side's job
        return multihost.task_worker(argv, _process)
    ap = argparse.ArgumentParser(
        description="sharded vs unsharded step time at identical total work "
                    "(one process per device)")
    ap.add_argument("-b", "--per_device_batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--image_len", type=int, default=200)
    ap.add_argument("--devices", default=None,
                    help="comma-separated device counts (default 2,4,8 up "
                         "to the number of devices)")
    ap.add_argument("--device_list", default=None,
                    help="comma-separated devices, one process each, repeats allowed "
                         "(default: every visible GPU; cpu,cpu to run on the CPU)")
    ap.add_argument("--json_out", default=None)
    args = ap.parse_args(argv)
    counts = ([int(x) for x in args.devices.split(",")]
              if args.devices else None)
    devices = multihost.job_devices(args.device_list.split(",") if args.device_list
                                    else None)
    rows = measure(counts, args.per_device_batch, args.steps, args.image_len, devices)
    if args.json_out:
        meta = {
            "platform": "cpu" if devices[0] == "cpu" else "gpu",
            "local_devices": len(devices),
            "host_cpus": os.cpu_count(),
            "per_device_batch": args.per_device_batch,
            "steps": args.steps,
            "image_len": args.image_len,
            "max_train_overhead": max(r["train_overhead"] for r in rows),
            "max_consensus_overhead": max(r["consensus_overhead"] for r in rows),
            "mean_train_overhead": round(
                sum(r["train_overhead"] for r in rows) / len(rows), 4),
            "mean_consensus_overhead": round(
                sum(r["consensus_overhead"] for r in rows) / len(rows), 4),
        }
        write_json(args.json_out, meta, rows, devices)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
