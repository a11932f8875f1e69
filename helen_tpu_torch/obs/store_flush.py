"""What a prediction-store flush costs at a genome run's flush size.

    python -m helen_tpu_torch.obs.store_flush [--batches 40] [--batch 512]

Drives the prediction store the way ``call_consensus``'s loop does at
``-b 512 --qualities``: each batch writes ``--batch`` records of one
full-width image each (1,000 columns: position, bases, rles and quals,
15,000 bytes), and ``flush()`` comes after batch 0, 10, 20, ..., so each
flush past the first covers ten batches (5,120 records, 76.8 MB). Three
cases: one store; one store with ``os.fsync`` made a no-op in this process
(the flush is then only the buffered one); a pool of four writer processes
(``--writers 4``). Each prints one JSON line: the seconds of every flush,
the seconds of the writes between flushes, and of the close. The stores go
to a temporary directory under the build directory and are removed after
each case. Host only: it imports no torch and needs no card (it prints the
card's name and power limit where ``nvidia-smi`` answers).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from unittest import mock

import numpy as np

COLS = 1000
FLUSH_EVERY = 10  # call_consensus flushes after every tenth batch


def records(batch: int, seed: int):
    """One batch's worth of full-width records (reused for every batch: the
    store's cost does not depend on the values)."""
    rng = np.random.default_rng(seed)
    position = np.zeros((COLS, 3), np.int64)
    position[:, 0] = np.arange(COLS)
    return [(position, rng.integers(0, 5, COLS).astype(np.uint8),
             rng.integers(0, 11, COLS).astype(np.uint8),
             rng.integers(0, 61, COLS).astype(np.uint8)) for _ in range(batch)]


def run(store, batches: int, batch: int) -> dict:
    recs = records(batch, seed=1)
    flushes, writes = [], []
    t_write = 0.0
    for bi in range(batches):
        t0 = time.perf_counter()
        for j, (pos, bases, rles, quals) in enumerate(recs):
            i = bi * batch + j
            # four chunks per region, as MarginPolish cuts a region into images
            start = (i // 4) * 900
            store.write_prediction("ctg", start, start + 1000, i % 4, pos, bases, rles, quals)
        t_write += time.perf_counter() - t0
        if bi % FLUSH_EVERY == 0:
            t0 = time.perf_counter()
            store.flush()
            flushes.append(time.perf_counter() - t0)
            writes.append(t_write)
            t_write = 0.0
    t0 = time.perf_counter()
    store.close()
    return {"flush_s": flushes, "write_s_before_each_flush": writes,
            "write_s_after_last_flush": t_write, "close_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    from helen_tpu_torch.io.prediction_store import PredictionStore
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool
    from helen_tpu_torch.utils.build import build_dir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args(argv)
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip().splitlines()[0])
    except (OSError, IndexError):
        print("no nvidia-smi")
    bytes_per_record = COLS * (12 + 3)
    cases = (("one store", 1, False), ("one store, os.fsync a no-op", 1, True),
             ("four writer processes", 4, False))
    for name, writers, no_fsync in cases:
        work = tempfile.mkdtemp(dir=build_dir("store_flush"))
        try:
            if writers == 1:
                store = PredictionStore(os.path.join(work, "p_0.hdf"), "w")
            else:
                store = PredictionWriterPool(
                    [os.path.join(work, f"p_0_w{k}.hdf") for k in range(writers)], "w")
            with mock.patch("os.fsync", lambda fd: None) if no_fsync else mock.MagicMock():
                out = run(store, args.batches, args.batch)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"case": name, "batches": args.batches, "batch": args.batch,
                          "mb_per_flush": FLUSH_EVERY * args.batch * bytes_per_record / 1e6,
                          **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
