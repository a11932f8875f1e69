"""Scaling-efficiency harness: consensus throughput vs device count.

Port of helen_tpu/tools/scaling_bench.py. helen_tpu measures the flagship
consensus program over growing subsets of one process's local devices on a
1-D data mesh; the port's counterpart of that is a **job**: one gloo process
per device (parallel.multihost.run_task), each taking its rows of every
global batch, weights replicated, the labels' sums reduced once at the end
(``allsum_hosts_exact``, the counterpart of helen_tpu's ``psum``). A device
count k is a job of k processes on the first k devices, one process too, so
every count pays the same set-up, outside the timed steps. A device list may
name one device more than once (``["cuda:0", "cuda:0"]``,
``["cpu", "cpu"]``): that stands in for helen_tpu's virtual 8-device CPU
mesh, and on one card measures what its processes' sharing of it costs.

Usage:
  python -m helen_tpu_torch.tools.scaling_bench [-b PER_DEVICE_BATCH]
      [--steps N] [--devices 1,2,4] [--backend pallas|pallas_fast|xla]
      [--device_list cuda:0,cuda:0] [--json_out F]

Prints one JSON line per device count, with helen_tpu's keys:
  {"devices": k, "windows_per_s": W, "per_device": W/k, "efficiency": e,
   "baseline_devices": k0, "backend": b}
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from helen_tpu_torch.config import IMAGE, WINDOW
from helen_tpu_torch.obs import card_label
from helen_tpu_torch.parallel import multihost


def batch_images(global_batch: int) -> np.ndarray:
    """The job's global batch: uint8 images from ``default_rng(0)``."""
    return np.random.default_rng(0).integers(
        0, 40, size=(global_batch, IMAGE.seq_length, IMAGE.feature_dim)).astype(np.uint8)


def _process(task: dict, device) -> dict:
    """One process of a count's job: its rows of the global batch, a
    warm-up batch, a barrier, ``steps`` timed batches whose label sums are
    summed over the job at the end, a barrier; its wall between the two."""
    import torch

    from helen_tpu_torch import ops
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import (
        consensus_labels,
        engaged_kernel,
        init_params,
        resolve_backend,
        set_fp32_precision,
    )

    set_fp32_precision()
    k, rank, b = multihost.process_count(), multihost.process_index(), task["per_device_batch"]
    params = params_to_torch(init_params(torch.Generator().manual_seed(0)), device)
    backend = resolve_backend(task["backend"], device, params)
    images = torch.from_numpy(batch_images(b * k)[rank * b:(rank + 1) * b]).to(device)

    def step():
        base, rle = consensus_labels(params, images, backend=backend)
        return base.sum(dtype=torch.int64), rle.sum(dtype=torch.int64)

    ops.reset_launch_counts()
    with torch.no_grad():
        [int(s) for s in step()]  # first launches (the kernels load) and warm-up
        multihost.barrier("scaling-start")
        t0 = time.perf_counter()
        sum_b, sum_r = step()
        for _ in range(1, task["steps"]):
            s_b, s_r = step()
            sum_b, sum_r = sum_b + s_b, sum_r + s_r
        sums = multihost.allsum_hosts_exact(np.array([int(sum_b), int(sum_r)]))
        multihost.barrier("scaling-end")
        seconds = time.perf_counter() - t0
    return {"rank": rank, "seconds": seconds, "label_sums": sums.tolist(),
            "batches": 1 + task["steps"], "launches": ops.launch_counts(),
            "backend": backend, "kernel": engaged_kernel(params, backend)}


def measure(
    device_counts: Optional[Sequence[int]] = None,
    per_device_batch: int = 256,
    steps: int = 6,
    backend: Optional[str] = None,
    devices: Optional[Sequence[str]] = None,
    records: Optional[Dict[int, List[dict]]] = None,
    timeout_s: Optional[float] = None,
) -> List[dict]:
    """Windows/s of consensus for each device count: a job of that many
    processes on the first devices of ``devices`` (default: every visible
    GPU; a list may repeat one). ``backend`` takes the port's names and
    helen_tpu's (``INFER_ALIASES``); the default is the kernels on a CUDA
    device, their plain versions on the CPU. ``records``, where given, gets
    each count's per-process results: seconds, the job's label sums over
    the timed batches, the batches run, the kernels' launches, the backend
    and the kernel family."""
    devices = multihost.job_devices(devices)
    if device_counts is None:
        device_counts = sorted({1, *[2 ** i for i in range(1, 6) if 2 ** i <= len(devices)]})
    # ascending, so the efficiency baseline is the SMALLEST measured count
    # (ideally 1); report which count the baseline used
    device_counts = sorted(k for k in device_counts if k <= len(devices))
    n_windows = WINDOW.num_windows(IMAGE.seq_length)
    results = []
    base = base_devices = None
    for k in device_counts:
        procs = multihost.run_task(__name__, {"per_device_batch": per_device_batch,
                                              "steps": steps, "backend": backend},
                                   devices[:k], timeout_s)
        if records is not None:
            records[k] = procs
        wall = max(p["seconds"] for p in procs)  # the slowest process's
        wps = steps * per_device_batch * k * n_windows / wall
        if base is None:
            base, base_devices = wps / k, k
        row = {
            "devices": k,
            "windows_per_s": round(wps, 1),
            "per_device": round(wps / k, 1),
            "efficiency": round((wps / k) / base, 4),
            "baseline_devices": base_devices,
            "backend": procs[0]["backend"],
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def main(argv=None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--task" in argv:  # a process of a count's job
        return multihost.task_worker(argv, _process)
    ap = argparse.ArgumentParser(
        description="consensus scaling efficiency vs device count (one process each)")
    ap.add_argument("-b", "--per_device_batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--devices", default=None,
                    help="comma-separated device counts (default: 1,2,4,... "
                         "up to the number of devices)")
    ap.add_argument("--backend", default=None, choices=["xla", "pallas", "pallas_fast"],
                    help="helen_tpu's names (models.transducer.INFER_ALIASES; default: "
                         "the kernels on a CUDA device, their plain versions on the CPU)")
    ap.add_argument("--device_list", default=None,
                    help="comma-separated devices, one process each, repeats allowed "
                         "(default: every visible GPU; cpu,cpu to run on the CPU)")
    ap.add_argument("--json_out", default=None,
                    help="also write {meta, rows} to this JSON file")
    args = ap.parse_args(argv)
    counts = ([int(x) for x in args.devices.split(",")]
              if args.devices else None)
    devices = multihost.job_devices(args.device_list.split(",") if args.device_list
                                    else None)
    rows = measure(counts, args.per_device_batch, args.steps, args.backend, devices)
    if args.json_out:
        meta = {
            "platform": "cpu" if devices[0] == "cpu" else "gpu",
            "device_kind": _device_kind(devices[0]),
            "local_devices": len(devices),
            "host_cpus": os.cpu_count(),
            "per_device_batch": args.per_device_batch,
            "steps": args.steps,
            "aggregate_ratio": round(
                rows[-1]["windows_per_s"] / rows[0]["windows_per_s"], 4
            ) if len(rows) > 1 else 1.0,
        }
        write_json(args.json_out, meta, rows, devices)
    return 0


def _device_kind(device: str) -> str:
    import torch

    return "cpu" if device == "cpu" else torch.cuda.get_device_name(torch.device(device))


def write_json(path: str, meta: dict, rows: List[dict], devices: Sequence[str]) -> None:
    """``{meta, rows}``; on a card ``meta`` also carries its name and power
    limit as nvidia-smi prints them."""
    if devices[0] != "cpu":
        meta["nvidia_smi"] = card_label()
    with open(path, "w") as f:
        json.dump({"meta": meta, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    import sys

    sys.exit(main())
