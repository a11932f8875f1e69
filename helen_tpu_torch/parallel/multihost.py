"""Multi-process jobs on torch.distributed with the gloo backend.

Port of helen_tpu/parallel/multihost.py. helen_tpu joins a job through
``jax.distributed`` and reduces over a global device mesh; the port runs
one process per device and joins them in a gloo process group:

* :func:`initialize` joins the job (an explicit ``host:port`` coordinator
  with the process count and index, or torchrun's environment through
  ``env://``); a single-process run is a no-op, and :func:`process_index`
  / :func:`process_count` then read 0 and 1;
* inference shards the work per process, contiguous equal-count **image**
  blocks (:func:`host_image_shard`) or round-robin whole **files**
  (:func:`host_file_shard`), each process writing ``<prefix>_<rank>.hdf``,
  which stitch merges;
* training sums the loss denominators and the gradients over the processes
  (train.train_loop), and evaluation sums its confusion matrices exactly
  (:func:`allsum_hosts_exact`) and its loss in float32
  (:func:`allsum_hosts`), the same on every process.

The collectives carry small host arrays (names, counts, the flattened
gradients), so gloo serves whether the processes share a card or each has
its own. :func:`launch_local` runs one worker process per local device of
one host over a loopback address: the port's counterpart of helen_tpu's
default data parallelism over a process's local devices. :func:`run_task`
runs a measurement that way (the tools scaling_bench and
sharding_overhead): a job of one process per device, each returning its
result to the caller.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from helen_tpu_torch.obs import get_logger

log = get_logger("multihost")

#: the default barrier timeout (helen_tpu's ``--barrier_timeout``): every
#: other process parks behind process 0's stitch, which is genome-scale work
DEFAULT_BARRIER_TIMEOUT_S = 86400.0
#: torchrun's environment, read by ``--distributed`` through ``env://``
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _dist():
    import torch.distributed as dist

    return dist


def _joined() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (``jax.process_index()``): 0 outside a job."""
    return _dist().get_rank() if _joined() else 0


def process_count() -> int:
    """The number of processes of the job (``jax.process_count()``)."""
    return _dist().get_world_size() if _joined() else 1


# the shard helpers' parameters take these names, as in helen_tpu
_rank, _world = process_index, process_count


def missing_flags(distributed: bool, coordinator_address: Optional[str],
                  num_processes: Optional[int], process_id: Optional[int],
                  environ=os.environ) -> Optional[str]:
    """What an incomplete set of the job flags lacks, or None when the set
    is complete (or empty: a single-process run). The explicit form needs
    all three of ``--coordinator_address``, ``--num_processes`` and
    ``--process_id``; ``--distributed`` without a coordinator reads
    :data:`TORCHRUN_ENV` (and, as helen_tpu's auto-discovery, ignores the
    other two)."""
    explicit = {"--coordinator_address": coordinator_address,
                "--num_processes": num_processes, "--process_id": process_id}
    given = [k for k, v in explicit.items() if v is not None]
    if coordinator_address is not None or (given and not distributed):
        lack = [k for k, v in explicit.items() if v is None]
        if lack:
            return f"{', '.join(given)} also need{'s' if len(given) == 1 else ''} " \
                   f"{' and '.join(lack)}"
        if not 0 <= process_id < num_processes:
            return f"--process_id {process_id} is not in [0, --num_processes {num_processes})"
        return None
    if distributed:
        lack = [k for k in TORCHRUN_ENV if not environ.get(k)]
        if lack:
            return (f"--distributed reads torchrun's environment, and "
                    f"{', '.join(lack)} {'is' if len(lack) == 1 else 'are'} not set "
                    "(or give --coordinator_address, --num_processes and --process_id)")
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S,
) -> None:
    """Join a multi-process job on gloo. No-op for a single-process run
    (no coordinator and ``auto`` False). ``coordinator_address`` is
    ``host:port`` of process 0 (``tcp://host:port``); ``auto=True`` without
    it reads torchrun's environment (``env://``: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) and, where CUDA is visible, takes
    ``cuda:LOCAL_RANK``. The group's timeout is at least ``timeout_s``,
    the longest barrier's: gloo's default of 30 minutes would abort a job
    whose processes park behind process 0's stitch."""
    import torch

    dist = _dist()
    if not auto and num_processes in (None, 1) and not coordinator_address:
        log.info("single-process run (no coordinator configured)")
        return
    timeout = datetime.timedelta(seconds=max(timeout_s, DEFAULT_BARRIER_TIMEOUT_S))
    if auto and not coordinator_address:
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        local = os.environ.get("LOCAL_RANK")
        if local is not None and torch.cuda.is_available():
            torch.cuda.set_device(int(local) % torch.cuda.device_count())
    else:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    log.info("joined distributed job: process %d/%d (gloo)", process_index(),
             process_count())


def shutdown() -> None:
    """Leave the job: destroy the process group, where this process joined
    one. A process that exits with its group open can abort in the group's
    teardown ("terminate called without an active exception")."""
    if _joined():
        _dist().destroy_process_group()


def host_file_shard(files: Sequence[str], process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> List[str]:
    """This process's round-robin shard of the input files (deterministic
    across processes; the reference's round-robin,
    CallConsensusInterface.py:134-145)."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    return [f for i, f in enumerate(sorted(files)) if i % pc == pi]


def host_image_shard(num_images: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[int]:
    """This process's contiguous equal-count block of the image index:
    balanced whatever the files' image counts, with sequential reads; each
    image's (region, chunk) store key is intrinsic, so placement stays
    deterministic."""
    pi = _rank() if process_index is None else process_index
    pc = _world() if process_count is None else process_count
    start = (num_images * pi) // pc
    end = (num_images * (pi + 1)) // pc
    return list(range(start, end))


def broadcast_name(name: str, max_len: int = 256) -> str:
    """Broadcast a short string (a run directory's name, a status) from
    process 0 to every process. Identity in a single-process run."""
    if process_count() == 1:
        return name
    import torch

    buf = np.zeros(max_len, dtype=np.uint8)
    if process_index() == 0:
        raw = name.encode("utf-8")
        if len(raw) > max_len:
            raise ValueError(f"name too long to broadcast: {name!r}")
        buf[: len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    t = torch.from_numpy(buf)
    _dist().broadcast(t, src=0)
    buf = t.numpy()
    return bytes(buf[buf != 0]).decode("utf-8")


def allsum_hosts(array: np.ndarray) -> np.ndarray:
    """Sum a small host array across the processes. Identity in a
    single-process run.

    As helen_tpu's (jax without x64), the values travel as float32 and the
    sum is taken in rank order after an all-gather, so every process
    computes the SAME rounded sum (what the LR scheduler's lockstep
    needs); elements above 2^24 lose integer exactness: counts go through
    :func:`allsum_hosts_exact`."""
    if process_count() == 1:
        return array
    import torch

    local = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    gathered = [torch.empty_like(local) for _ in range(process_count())]
    _dist().all_gather(gathered, local)
    return np.stack([g.numpy() for g in gathered]).sum(axis=0)


def _split_limbs(values: np.ndarray) -> np.ndarray:
    """Non-negative integer-valued array -> (3, ...) float64 16-bit limbs."""
    v = np.rint(np.asarray(values)).astype(np.int64)
    if (v < 0).any():
        raise ValueError("allsum_hosts_exact requires non-negative counts")
    if (v >= 1 << 48).any():
        # the top limb is carried unmasked; values >= 2^48 would overflow it
        raise ValueError("allsum_hosts_exact requires per-host values < 2**48")
    return np.stack([v & 0xFFFF, (v >> 16) & 0xFFFF, v >> 32]).astype(np.float64)


def _combine_limbs(limbs: np.ndarray) -> np.ndarray:
    w = np.rint(np.asarray(limbs)).astype(np.int64)
    return w[0] + (w[1] << 16) + (w[2] << 32)


def allsum_hosts_exact(counts: np.ndarray) -> np.ndarray:
    """Sum non-negative integer-valued arrays across the processes
    EXACTLY: each value split into 16-bit limbs, each limb summed in
    float32 (exact while a limb sum stays below 2^24: up to 256 processes
    with per-process values below 2^48), recombined in int64. Returns
    int64."""
    v = np.rint(np.asarray(counts)).astype(np.int64)
    if process_count() == 1:
        return v
    return _combine_limbs(allsum_hosts(_split_limbs(v)))


def allreduce_sum(tensor):
    """Sum a tensor over the processes, in place on its device: one gloo
    all_reduce of a host copy (the processes may share one card, where
    NCCL refuses two ranks). Every process gets the same bits: gloo's ring
    reduces each slice once and passes the sum on. Identity in a
    single-process run."""
    if process_count() == 1:
        return tensor
    host = tensor.detach().to("cpu", copy=True).contiguous()
    _dist().all_reduce(host)
    return tensor.copy_(host)


def barrier(name: str = "helen_tpu", timeout_s: float = DEFAULT_BARRIER_TIMEOUT_S) -> None:
    """Cross-process sync point (the reference's dist.barrier,
    train_distributed.py:243,253): gloo's monitored barrier, which raises
    once ``timeout_s`` passes without every process arriving, naming the
    barrier; it never hangs. The default is helen_tpu's 24 h: processes
    park here behind process 0's stitch."""
    if process_count() == 1:
        return
    try:
        _dist().monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s),
                                  wait_all_ranks=True)
    except RuntimeError as exc:
        raise TimeoutError(f"barrier {name!r}: not every process arrived within "
                           f"{timeout_s:g} s ({exc})") from exc


# ---------------------------------------------------------------------------
# one worker process per local device
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(device: str, environ=os.environ) -> dict:
    """The environment of a worker on ``device`` (``"cpu"`` or
    ``"cuda:k"``): a CUDA worker sees only its card, as its ``cuda:0``, so
    ``--device cuda`` reaches it and it launches no workers of its own; and
    ``python -m`` finds this copy of the package first, whatever the
    working directory."""
    env = dict(environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in [environ.get("PYTHONPATH")] if p])
    if device.startswith("cuda"):
        index = int(device.partition(":")[2] or 0)
        visible = environ.get("CUDA_VISIBLE_DEVICES")
        env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[index] if visible
                                       else str(index))
    return env


def launch_local(argv: Sequence[str], devices: Sequence[str],
                 timeout_s: Optional[float] = None, module: str = "helen_tpu_torch") -> int:
    """Run the command line ``argv`` (a subcommand and its flags) as
    ``len(devices)`` worker processes of one job over a loopback
    ``tcp://`` address: ``<this python> -m <module>
    --coordinator_address 127.0.0.1:<free port> --num_processes N
    --process_id i <argv>``, worker i on ``devices[i]`` (:func:`worker_env`;
    ``"cpu"`` workers need ``--device cpu`` in ``argv``); their output and
    errors go where this process's go. When a worker fails the others are
    stopped (they would wait at the next collective); returns 0, or the
    first failing worker's exit code (124 past ``timeout_s``)."""
    n = len(devices)
    if n < 1:
        raise ValueError("launch_local needs at least one device")
    addr = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--coordinator_address", addr,
         "--num_processes", str(n), "--process_id", str(i), *argv], env=worker_env(dev))
        for i, dev in enumerate(devices)]
    log.info("launched %d worker processes on %s (gloo at %s)", n, list(devices), addr)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed or (deadline is not None and time.monotonic() > deadline):
                rc = failed[0] if failed else 124
                break
            time.sleep(0.2)
        else:
            rc = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    if rc:
        log.error("a worker process failed (exit code %d); stopped the others", rc)
    return rc


# ---------------------------------------------------------------------------
# a measurement as a job of one process per device
# ---------------------------------------------------------------------------

def job_devices(devices: Optional[Sequence[str]] = None) -> List[str]:
    """The devices of a measured job, one process each: ``devices`` as
    given (a list may name one device more than once, ``["cuda:0",
    "cuda:0"]`` or ``["cpu", "cpu"]``, as parallel.mesh allows), or every
    visible GPU. With none visible it raises: a measurement never falls
    back to the CPU unless the caller names it."""
    if devices is not None:
        devices = [str(d) for d in devices]
        if not devices or any(d != "cpu" and not d.startswith("cuda") for d in devices):
            raise ValueError(f"devices must be 'cpu' or 'cuda[:k]' names, got {devices}")
        return devices
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is visible: name the devices to run on the CPU "
                           "(devices=['cpu', 'cpu'], --device_list cpu,cpu)")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def run_task(module: str, task: dict, devices: Sequence[str],
             timeout_s: Optional[float] = None) -> List[dict]:
    """Run ``task`` (a JSON-able dict) as a job of ``len(devices)``
    processes of ``python -m <module>`` through :func:`launch_local`, each
    on its device, whose ``main`` hands its arguments to
    :func:`task_worker`; returns each process's result, by rank. A process
    that fails, or a job past ``timeout_s``, raises."""
    with tempfile.TemporaryDirectory(prefix="helen_job_") as out:
        spec = os.path.join(out, "task.json")
        with open(spec, "w") as f:
            json.dump({**task, "devices": list(devices), "out": out}, f)
        rc = launch_local(["--task", spec], devices, timeout_s, module=module)
        if rc:
            raise RuntimeError(f"the {module} job on {list(devices)} failed (exit code {rc})")
        results = []
        for rank in range(len(devices)):
            with open(os.path.join(out, f"result_{rank}.json")) as f:
                results.append(json.load(f))
        return results


def task_worker(argv: Sequence[str], run: Callable) -> int:
    """One process of a :func:`run_task` job: ``argv`` holds the job flags
    and ``--task <spec>``. Joins the job, calls ``run(task, device)`` on its
    device (a CUDA worker sees only its card, as ``cuda:0``) and writes what
    it returns where :func:`run_task` reads it."""
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator_address", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--task", required=True)
    args = ap.parse_args(argv)
    with open(args.task) as f:
        task = json.load(f)
    device = (torch.device("cpu") if task["devices"][args.process_id] == "cpu"
              else torch.device("cuda", 0))
    initialize(args.coordinator_address, args.num_processes, args.process_id)
    try:
        result = run(task, device)
    finally:
        shutdown()
    with open(os.path.join(task["out"], f"result_{args.process_id}.json"), "w") as f:
        json.dump(result, f)
    return 0
