"""Multi-process prediction writer pool.

The port writes its prediction store through a pure-Python HDF5 writer
(io.hdf5) that runs under the GIL, in the process that also drains the
device's labels. The pool runs K writer processes, each owning ONE shard
file ``<prefix>_<host>_w<k>.hdf``; image chunks route to a deterministic
writer by region key, and the stitch engine already merges regions across
any number of prediction files (io/prediction_store.list_region_keys — the
same machinery that merges multi-host shards), so downstream behavior is
unchanged.

Duplicate/resume semantics stay first-write-wins and pool-wide: the parent
process keeps the union of every shard's (region, chunk) keys (collected from the
workers at startup), so a resumed run skips chunks no matter which shard —
or which previous pool size — wrote them.

API-compatible with PredictionStore for everything the consensus loop
uses: ``write_prediction``, ``has_chunk``, ``flush``, ``close``, context
manager, plus ``paths``. The workers import numpy and io.hdf5, never torch.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import zlib
from typing import List, Sequence, Set, Tuple

from helen_tpu_torch.io.prediction_store import _chunk_keys
from helen_tpu_torch.obs import get_logger

log = get_logger("writer_pool")

_SENTINEL = "stop"
_FLUSH = "flush"
# records buffer per writer and ship in blocks: a multiprocessing queue put
# costs a feeder-thread hop and a pickle per ITEM; one block amortizes that
# over BLOCK_RECORDS pickled-as-one arrays
BLOCK_RECORDS = 128
QUEUE_DEPTH = 8  # blocks in flight to each writer


def _writer_main(path: str, mode: str, work_q, result_q) -> None:
    """Worker: own one shard file; apply record blocks in arrival order.

    The idle loop polls with a timeout and watches the PARENT pid: if the
    parent is SIGKILLed (preemption, OOM killer), daemon children are NOT
    reaped by Python — an orphaned writer would sit in ``work_q.get()``
    forever. Orphans instead close the store (publishing the shard, readable
    and complete up to the last record they received) and exit within ~5 s."""
    try:
        from helen_tpu_torch.io.prediction_store import PredictionStore

        parent = os.getppid()
        store = PredictionStore(path, mode)
        # report pre-existing chunks (resume) so the parent can build the
        # pool-wide dedupe set
        result_q.put(("chunks", sorted(store._chunks)))
        while True:
            try:
                item = work_q.get(timeout=5)
            except queue_mod.Empty:
                if os.getppid() != parent:  # the parent died; we are orphaned
                    store.close()
                    return
                continue
            if item == _SENTINEL:
                break
            if item == _FLUSH:
                store.flush()
                result_q.put(("flushed", path))
                continue
            for contig, cs, ce, cid, position, bases, rles, quals in item:
                store.write_prediction(contig, cs, ce, cid, position, bases,
                                       rles, quals)
        store.close()
        result_q.put(("done", path))
    except Exception as exc:  # surfaced by the parent
        import traceback

        result_q.put(("error", f"{exc!r}\n{traceback.format_exc()}"))


class PredictionWriterPool:
    """K spawn-processes, each writing one prediction shard file."""

    def __init__(self, paths: Sequence[str], mode: str = "w",
                 extra_key_files: Sequence[str] = ()):
        assert len(paths) >= 1
        self.paths: List[str] = list(paths)
        # resume across pool-size changes: shards a PREVIOUS run wrote under
        # a different --writers count (or the single-writer file) are not in
        # ``paths``; their (region, chunk) keys preload the dedupe set so
        # those chunks are skipped, not recomputed and duplicated
        self._preload: Set[Tuple[str, str]] = set()
        for path in extra_key_files:
            self._preload.update(_chunk_keys(path))
        self._buffers: List[list] = [[] for _ in paths]
        ctx = multiprocessing.get_context("spawn")
        self._result_q = ctx.Queue()
        self._work_qs = []
        self._procs = []
        self._chunks: Set[Tuple[str, str]] = set()
        self._closed = False
        # writer processes are pure-CPU (numpy + io.hdf5): scrub
        # accelerator-bootstrap env vars so each spawned interpreter starts
        # lean (utils.procs.lean_worker_env)
        from helen_tpu_torch.utils.procs import lean_worker_env

        with lean_worker_env():
            for path in self.paths:
                q = ctx.Queue(maxsize=QUEUE_DEPTH)
                p = ctx.Process(target=_writer_main,
                                args=(path, mode, q, self._result_q),
                                daemon=True)
                p.start()
                self._work_qs.append(q)
                self._procs.append(p)
        # startup barrier: every worker reports its existing chunk keys (or
        # an error, e.g. an unwritable path) before any writes are routed.
        # Poll with liveness checks — a worker that dies before reporting
        # (e.g. spawn re-import of a __main__ without a main guard) must
        # raise here, not hang the parent forever.
        for _ in self.paths:
            while True:
                try:
                    kind, payload = self._result_q.get(timeout=5)
                    break
                except queue_mod.Empty:
                    dead = [p for p in self._procs if not p.is_alive()]
                    if dead:
                        self._abort()
                        raise RuntimeError(
                            "prediction writer died during startup (exit "
                            f"codes {[p.exitcode for p in dead]}); if driving "
                            "from a script, guard it with "
                            "if __name__ == '__main__' (spawn re-imports it)"
                        )
            if kind == "error":
                self._abort()
                raise RuntimeError(f"prediction writer failed to start: {payload}")
            self._chunks.update(tuple(k) for k in payload)
        self._chunks.update(self._preload)

    # -- PredictionStore-compatible surface --------------------------------

    def has_chunk(self, contig: str, contig_start: int, contig_end: int,
                  chunk_id: int) -> bool:
        region = f"{contig}-{contig_start}-{contig_end}"
        return (region, str(chunk_id)) in self._chunks

    def write_prediction(self, contig, contig_start, contig_end, chunk_id,
                         position, bases, rles, quals=None) -> bool:
        if "/" in contig:
            raise ValueError(
                f"contig name {contig!r} contains '/', which is not "
                "representable in the prediction-store HDF5 layout"
            )
        region = f"{contig}-{contig_start}-{contig_end}"
        key = (region, str(chunk_id))
        if key in self._chunks:
            return False
        self._chunks.add(key)
        self._check_errors()
        # region-keyed routing keeps a region's chunks in one file (read
        # locality at stitch); stitch merges across files either way. crc32,
        # not hash(): str hashes are salted per process and stable shard
        # contents make runs reproducible
        w = zlib.crc32(region.encode()) % len(self._work_qs)
        buf = self._buffers[w]
        buf.append(
            (contig, int(contig_start), int(contig_end), int(chunk_id),
             position, bases, rles, quals)
        )
        if len(buf) >= BLOCK_RECORDS:
            self._ship(w)
        return True

    def _ship(self, w: int) -> None:
        if not self._buffers[w]:
            return
        try:
            self._work_qs[w].put(self._buffers[w], timeout=600)
        except queue_mod.Full:
            self._abort()
            raise RuntimeError(
                f"prediction writer {w} stopped consuming (process killed?)"
            )
        self._buffers[w] = []

    def flush(self) -> None:
        """Ship buffered records, ask every worker to flush its file, and
        wait until all have (so a hard kill right after flush() leaves every
        shard resumable)."""
        self._check_errors()
        for w in range(len(self._work_qs)):
            self._ship(w)
        for w, q in enumerate(self._work_qs):
            try:
                q.put(_FLUSH, timeout=600)
            except queue_mod.Full:
                self._abort()
                raise RuntimeError(
                    f"prediction writer {w} stopped consuming (process killed?)"
                )
        pending = len(self._work_qs)
        while pending:
            # poll with liveness checks: a worker killed without reporting
            # (OOM/SIGKILL) must raise here, never hang the polish job
            try:
                kind, payload = self._result_q.get(timeout=5)
            except queue_mod.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self._abort()
                    raise RuntimeError(
                        "prediction writer died during flush (exit codes "
                        f"{[p.exitcode for p in dead]})"
                    )
                continue
            if kind == "error":
                self._abort()
                raise RuntimeError(f"prediction writer failed: {payload}")
            if kind == "flushed":
                pending -= 1

    def close(self) -> None:
        if self._closed:
            return
        for w in range(len(self._work_qs)):
            self._ship(w)
        self._closed = True
        # bounded put with liveness checks: if a worker died with its queue
        # full, an unbounded put would block forever and never reach the
        # liveness-checked drain loop below
        for w, q in enumerate(self._work_qs):
            while True:
                try:
                    q.put(_SENTINEL, timeout=5)
                    break
                except queue_mod.Full:
                    if not self._procs[w].is_alive():
                        self._abort()
                        raise RuntimeError(
                            f"prediction writer {w} died before close (exit "
                            f"code {self._procs[w].exitcode})"
                        )
        done = 0
        waited = 0.0
        while done < len(self._procs):
            try:
                kind, payload = self._result_q.get(timeout=5)
            except queue_mod.Empty:
                waited += 5
                # every worker enqueues "done" before exiting, so an empty
                # queue with no live workers means one died mid-write
                if all(not p.is_alive() for p in self._procs) or waited > 600:
                    self._abort()
                    raise RuntimeError(
                        "prediction writer hung or died during close (exit "
                        f"codes {[p.exitcode for p in self._procs]})"
                    )
                continue
            if kind == "error":
                self._abort()
                raise RuntimeError(f"prediction writer failed: {payload}")
            if kind == "done":
                done += 1
        for p in self._procs:
            p.join(timeout=60)

    def __enter__(self) -> "PredictionWriterPool":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._abort()  # don't mask the parent's exception with a hang
        else:
            self.close()

    # -----------------------------------------------------------------------

    def _check_errors(self) -> None:
        try:
            kind, payload = self._result_q.get_nowait()
        except queue_mod.Empty:
            return
        if kind == "error":
            self._abort()
            raise RuntimeError(f"prediction writer failed: {payload}")
        # stray non-error messages (e.g. late "flushed") are dropped

    def _abort(self) -> None:
        self._closed = True
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
