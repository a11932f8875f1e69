"""Streaming stitch: overlap stitching with consensus calling.

The classic polish pipeline serializes its stages — consensus writes every
prediction to the HDF5 store, THEN the stitcher reads them all back and
reassembles contigs (the reference does the same, PolishInterface.py:49-105).
On a fast chip the stitch stage is a pure wall-time tail: by the time
consensus finishes, every byte the stitcher needs has already been through
the main process's memory once.

This module removes that tail. The consensus loop feeds each image's
predictions (the same arrays it writes to the store) into a
:class:`StreamingStitcher` as they drain from the device. A pre-scan of the
dataset's metadata (``image_meta`` — free on the packed cache) tells the
stitcher exactly how many chunks every MarginPolish region expects, so the
moment a region seals, its chunks ship to the (pre-warmed) stitch process
pool IN MEMORY — no store read-back — in small sub-batches (level-1 merge
tasks; main-process memory stays bounded at a few sub-batches, never a whole
group, and no drain-loop submit pickles more than a few MB). As the last
sub-batch of a worker group returns, a completion callback submits the
level-2 within-group join, so merges AND joins run while the device is still
chewing the remaining batches. When consensus ends, ``finish_iter`` only
performs the cheap in-order per-contig final joins.

Byte-identity with the store-path stitch is structural, not incidental —
every divergence point of the classic path is replayed:

  * chunk payloads convert ``position`` to uint32 before merging, so short
    images' (-1,-1,-1) padding rows wrap to 4294967295 exactly as the store
    round-trip wraps them (prediction_store.write_prediction docstring);
  * chunks merge in lexicographic str(chunk_id) order ('10' < '2'), the
    order read_region_chunks yields after the store round-trip;
  * only records the store accepted (first-write-wins dedupe) are fed, so
    duplicate (region, chunk) inputs resolve identically;
  * regions partition into the same worker groups as Stitcher._plan (same
    group-size formula over the same (start, end)-sorted region list), so
    the hierarchical alignment_stitch tree is identical.

The stitcher refuses to engage (``polish`` falls back to the classic path)
under multi-host runs (process 0 cannot see other hosts' predictions in
memory) and under --resume (previously-stored chunks never re-run, so the
in-memory view would be incomplete). A worker failure mid-stream degrades
per group: the store — fully written by finish time — is re-read for just
that group via the classic worker. The whole stream breaks (every buffer
dropped, the classic stitch of the complete store takes over) on a record
the plan did not predict, including a second record for a region that has
already sealed, and when the chunks buffered in regions not yet sealed pass
``StreamingStitcher.UNSEALED_BYTES_LIMIT`` bytes.
"""
from __future__ import annotations

import concurrent.futures
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from helen_tpu_torch.config import STITCH, StitchConfig
from helen_tpu_torch.obs import get_logger
from helen_tpu_torch.stitch.engine import (
    _stitch_key_group,
    alignment_stitch,
    merge_region_chunks,
    merge_region_chunks_with_quality,
)
from helen_tpu_torch.utils.filesystem import chunk_list

log = get_logger("stitch.stream")

# build_stream_plan's pre-scan costs ~4 tiny HDF5 reads per image on the
# UNPACKED dataset (MarginPolishDataset.image_meta) — a serial startup
# stall the classic path never pays. Above this many images, polish only
# streams when the dataset advertises CHEAP_META (the packed cache, whose
# metadata is already in memory); genome-scale runs should use --pack
# anyway (docs/usage.md).
PRESCAN_IMAGE_LIMIT = 25_000


def _stitch_mem_merge(
    contig: str,
    regions: Sequence[Tuple[int, int, List[tuple]]],
    cfg: StitchConfig,
    with_quality: bool,
):
    """Pool worker, level 1: merge a SUB-BATCH of sealed regions from
    in-memory chunk payloads into (contig, start, end, seq[, qual]) tuples.
    The in-memory twin of the per-region half of engine._stitch_key_group:
    same str(chunk_id)-sorted chunk order through the shared
    _dedupe_region_rows. Sub-batches are a submission granularity only —
    each region merges independently, so the batch boundaries cannot affect
    output (the level-2 join re-sorts regions by span)."""
    region_sequences = []
    for start, end, chunks in regions:
        ordered = sorted(chunks, key=lambda c: str(c[0]))
        if with_quality:
            seq, qual = merge_region_chunks_with_quality(
                (pos, bases, rles, quals)
                for _, pos, bases, rles, quals in ordered
            )
            region_sequences.append((contig, int(start), int(end), seq, qual))
        else:
            seq = merge_region_chunks(
                (pos, bases, rles) for _, pos, bases, rles, *_ in ordered
            )
            region_sequences.append((contig, int(start), int(end), seq))
    return region_sequences


def _stitch_mem_join(region_sequences, cfg: StitchConfig):
    """Pool worker, level 2: the within-group alignment_stitch over one
    whole worker-group's merged region sequences (alignment_stitch sorts by
    span itself, exactly as engine._stitch_key_group relies on)."""
    return alignment_stitch(region_sequences, cfg)


class _Region:
    __slots__ = ("start", "end", "expected", "received", "chunks", "group")

    def __init__(self, start: int, end: int, group: int):
        self.start = start
        self.end = end
        self.expected = 0
        self.received = 0  # chunks accepted; == expected once sealed
        self.chunks: List[tuple] = []  # buffered until the region seals
        self.group = group


class _Group:
    __slots__ = ("regions", "remaining", "keys", "pending", "pending_bytes",
                 "merge_futures", "merge_outstanding", "join_future",
                 "failed")

    def __init__(self, keys: List[str]):
        self.keys = keys  # region keys, in plan order
        self.regions: List[_Region] = []
        self.remaining = 0          # regions not yet sealed
        self.pending: List[tuple] = []   # sealed regions awaiting submit
        self.pending_bytes = 0
        self.merge_futures: List[concurrent.futures.Future] = []
        self.merge_outstanding = 0
        self.join_future: Optional[concurrent.futures.Future] = None
        self.failed = False


class StreamPlan:
    """Region-completion bookkeeping derived from a dataset metadata
    pre-scan: which (contig, region) every image belongs to, how many chunks
    each region expects, and the exact worker grouping Stitcher._plan would
    produce for the finished store."""

    def __init__(self, contig_groups: Dict[str, List[_Group]],
                 regions: Dict[Tuple[str, str], _Region]):
        self.contig_groups = contig_groups  # contig -> groups in plan order
        self.regions = regions              # (contig, region_key) -> _Region

    @property
    def contigs(self) -> List[str]:
        return sorted(self.contig_groups)


def build_stream_plan(dataset, indices: Optional[Sequence[int]],
                      threads: int, cfg: StitchConfig = STITCH) -> StreamPlan:
    """Pre-scan the dataset metadata and build the streaming plan.

    ``indices`` limits the scan to the images this run will actually process
    (None = all). Region grouping replays Stitcher._plan exactly: regions
    sorted by (start, end), group size
    ``max(cfg.min_sequence_for_multithreading, n // threads + 1)``.
    """
    idx = range(len(dataset)) if indices is None else indices
    # (contig, start, end) -> set of chunk_id ints (store dedupe granularity)
    seen: Dict[Tuple[str, int, int], set] = {}
    for i in idx:
        contig, start, end, chunk_id = dataset.image_meta(i)
        seen.setdefault((contig, start, end), set()).add(chunk_id)

    per_contig: Dict[str, List[Tuple[int, int, str, int]]] = {}
    for (contig, start, end), chunk_ids in seen.items():
        region_key = f"{contig}-{start}-{end}"
        per_contig.setdefault(contig, []).append(
            (start, end, region_key, len(chunk_ids))
        )

    threads = max(1, threads)
    contig_groups: Dict[str, List[_Group]] = {}
    regions: Dict[Tuple[str, str], _Region] = {}
    for contig, rows in per_contig.items():
        rows.sort(key=lambda r: (r[0], r[1]))
        group_size = max(
            cfg.min_sequence_for_multithreading,
            len(rows) // threads + 1,
        )
        groups = []
        for chunk in chunk_list(rows, group_size):
            g = _Group([r[2] for r in chunk])
            for start, end, region_key, expected in chunk:
                region = _Region(start, end, len(groups))
                region.expected = expected
                g.regions.append(region)
                regions[(contig, region_key)] = region
            g.remaining = len(g.regions)
            groups.append(g)
        contig_groups[contig] = groups
    return StreamPlan(contig_groups, regions)


class StreamingStitcher:
    """Incremental stitcher fed by the consensus drain loop.

    Construction takes a :class:`StreamPlan` and a pre-warmed process pool
    (ownership transfers: a successful ``finish_iter`` shuts it down; on the
    degraded path, ``abort`` hands it back for the classic stitcher). The
    consensus loop calls :meth:`add` for every record the prediction store
    ACCEPTED; sealed regions ship to the pool in sub-batches immediately,
    and group joins chain off their completion callbacks.
    """

    # submission granularity: sealed regions ship to the pool in small
    # sub-batches so main-process memory stays bounded (chunks free at region
    # seal, not group seal) and no single submit pickles a genome-scale
    # payload inside the drain loop. ~32 regions x ~1-2 chunks x ~15 KB
    # of arrays per chunk = a few-MB pickle, milliseconds.
    SUB_BATCH_REGIONS = 32
    SUB_BATCH_BYTES = 8 << 20
    # bound on the label bytes buffered in regions not yet sealed. Images
    # arrive in region order, so a handful of regions is open at a time
    # (~15 KB a chunk); past the bound the stream is out of order at a scale
    # main-process memory should not absorb, and the store stitch takes over
    UNSEALED_BYTES_LIMIT = 1 << 30

    def __init__(self, plan: StreamPlan, cfg: StitchConfig = STITCH,
                 with_quality: bool = False, executor=None,
                 sub_batch_regions: Optional[int] = None):
        import threading

        self.plan = plan
        self.cfg = cfg
        self.with_quality = with_quality
        self._executor = executor
        self.broken = executor is None
        self._unsealed = sum(r.expected for r in plan.regions.values())
        self._unsealed_bytes = 0  # payload bytes in regions not yet sealed
        self._lock = threading.Lock()  # guards group merge/join bookkeeping
        if sub_batch_regions is not None:
            self.SUB_BATCH_REGIONS = sub_batch_regions

    def add(self, rec, bases: np.ndarray, rles: np.ndarray,
            quals: Optional[np.ndarray] = None) -> None:
        """Feed one store-accepted record (rec carries contig/span/chunk_id/
        position). Copies the label rows — they are views into the batch
        arrays, which must not be pinned in main-process memory."""
        if self.broken:
            return
        region_key = f"{rec.contig}-{rec.contig_start}-{rec.contig_end}"
        region = self.plan.regions.get((rec.contig, region_key))
        if region is None or region.received >= region.expected:
            # a record the plan did not predict — the pre-scan and the
            # stream disagree, so the in-memory view cannot be trusted
            log.warning("stream plan mismatch at %s chunk %s; falling back "
                        "to store stitch", region_key, rec.chunk_id)
            self._mark_broken()
            return
        payload = (
            rec.chunk_id,
            # uint32 BEFORE the merge: replays the store's dtype wrap of
            # (-1,-1,-1) padding rows (write_prediction docstring)
            np.ascontiguousarray(rec.position, dtype=np.uint32),
            np.array(bases, dtype=np.uint8),
            np.array(rles, dtype=np.uint8),
        )
        if self.with_quality:
            if quals is None:
                log.warning("stream stitch: record %s chunk %s has no "
                            "quality row in a --fastq run; falling back to "
                            "store stitch", region_key, rec.chunk_id)
                self._mark_broken()
                return
            payload = payload + (np.array(quals, dtype=np.uint8),)
        region.chunks.append(payload)
        region.received += 1
        self._unsealed -= 1
        self._unsealed_bytes += sum(a.nbytes for a in payload[1:])
        if region.received < region.expected:
            if self._unsealed_bytes > self.UNSEALED_BYTES_LIMIT:
                log.warning("stream stitch: %d bytes buffered in unsealed "
                            "regions (limit %d); falling back to store stitch",
                            self._unsealed_bytes, self.UNSEALED_BYTES_LIMIT)
                self._mark_broken()
            return
        group = self.plan.contig_groups[rec.contig][region.group]
        group.pending.append((region.start, region.end, region.chunks))
        region_bytes = sum(a.nbytes for c in region.chunks for a in c[1:])
        group.pending_bytes += region_bytes
        self._unsealed_bytes -= region_bytes
        region.chunks = []  # ownership moved to the pending sub-batch
        group.remaining -= 1
        if (group.remaining == 0
                or len(group.pending) >= self.SUB_BATCH_REGIONS
                or group.pending_bytes >= self.SUB_BATCH_BYTES):
            self._submit_merge(group)

    def _submit_merge(self, group: _Group) -> None:
        """Ship the group's pending sub-batch to a level-1 merge worker.
        Called from the consensus thread only."""
        from helen_tpu_torch.utils.procs import lean_worker_env

        contig = group.keys[0].rsplit("-", 2)[0]
        with self._lock:
            batch, group.pending = group.pending, []
            group.pending_bytes = 0
            # RESERVE the slot before the (multi-ms, pickling) submit: an
            # earlier sub-batch's done-callback running inside this window
            # would otherwise see remaining==0 / pending empty /
            # outstanding==0 and submit the level-2 join WITHOUT this final
            # sub-batch — silently dropping its regions from the contig
            group.merge_outstanding += 1
        try:
            with lean_worker_env():
                fut = self._executor.submit(
                    _stitch_mem_merge, contig, batch, self.cfg,
                    self.with_quality,
                )
        except (concurrent.futures.process.BrokenProcessPool,
                RuntimeError) as exc:
            with self._lock:
                group.merge_outstanding -= 1
            log.warning("stream stitch pool unusable (%s); falling back to "
                        "store stitch", exc)
            self._mark_broken()
            return
        with self._lock:
            # appended before the callback registration so the callback's
            # join submit always sees its own future in merge_futures
            group.merge_futures.append(fut)
        # the callback fires in the pool's result-handler thread as each
        # sub-batch finishes; the LAST one submits the level-2 group join —
        # so joins overlap consensus too, not just merges
        fut.add_done_callback(lambda f, g=group: self._merge_done(g, f))

    def _merge_done(self, group: _Group, fut) -> None:
        with self._lock:
            group.merge_outstanding -= 1
            if fut.cancelled() or fut.exception() is not None:
                group.failed = True
                return
            self._maybe_submit_join_locked(group)

    def _maybe_submit_join_locked(self, group: _Group) -> None:
        """Submit the level-2 join once every region is sealed and every
        merge sub-batch is back. Caller holds self._lock. Runs in the
        callback thread (all pool workers are pre-spawned by
        prewarm_stitch_pool, so no lean_worker_env needed — submit here
        never lazily spawns a worker)."""
        if (group.failed or group.join_future is not None
                or group.remaining != 0 or group.pending
                or group.merge_outstanding != 0):
            return
        region_sequences = []
        for f in group.merge_futures:
            region_sequences.extend(f.result())
        group.merge_futures = []
        try:
            group.join_future = self._executor.submit(
                _stitch_mem_join, region_sequences, self.cfg,
            )
        except (concurrent.futures.process.BrokenProcessPool,
                RuntimeError) as exc:
            log.warning("stream stitch pool unusable at join (%s); group "
                        "will re-read from the store", exc)
            group.failed = True

    def _mark_broken(self) -> None:
        self.broken = True
        for groups in self.plan.contig_groups.values():
            for g in groups:
                with self._lock:
                    for f in g.merge_futures:
                        f.cancel()
                    if g.join_future is not None:
                        g.join_future.cancel()
                    g.failed = True
                g.regions = []
                g.pending = []
        # the buffers of unsealed regions too: nothing streamed is kept
        for region in self.plan.regions.values():
            region.chunks = []
        self._unsealed_bytes = 0

    def ready(self) -> bool:
        """True when every region sealed and shipped — the precondition for
        finish_iter."""
        return not self.broken and self._unsealed == 0

    def abort(self):
        """Give the executor back (for the classic stitcher) and drop any
        streamed state. Safe to call in any state."""
        self._mark_broken()
        ex, self._executor = self._executor, None
        return ex

    def _group_result(self, prediction_files: List[str], contig: str,
                      group: _Group):
        """Resolve one group: wait out its merges, close the join race with
        the callback thread, fall back to the store on any failure."""
        import time

        with self._lock:
            futs = list(group.merge_futures)
        if futs:
            concurrent.futures.wait(futs)
        # wait() can return BEFORE the done-callbacks have run (CPython
        # wakes waiters, then invokes callbacks), so merge_outstanding may
        # briefly lag the futures' actual state — settle it with a short
        # poll rather than misreading a healthy group as failed. Both the
        # callback and this thread are join_future-guarded under the lock,
        # so exactly one submits the level-2 join.
        deadline = time.monotonic() + 10.0
        while True:
            with self._lock:
                self._maybe_submit_join_locked(group)
                jf, failed = group.join_future, group.failed
                callbacks_pending = group.merge_outstanding != 0
            if jf is not None or failed or not callbacks_pending:
                break
            if time.monotonic() >= deadline:  # callbacks wedged
                failed = True
                break
            time.sleep(0.001)
        exc = None if failed or jf is None else jf.exception()
        if not failed and jf is not None and exc is None:
            return jf.result()
        if exc is not None:
            log.warning("stream stitch join failed (%s); re-reading group "
                        "from the store", exc)
        else:
            log.warning("stream stitch group failed; re-reading from the "
                        "store")
        return self._reread_group(prediction_files, contig, group)

    def finish_iter(self, prediction_files: List[str]) -> Iterator[tuple]:
        """Yield (contig, sequence[, quality]) rows in sorted contig order
        (the classic stitch_iter contract). Groups whose workers failed are
        recomputed from the now-complete prediction store."""
        assert self.ready(), "finish_iter on an incomplete/broken stream"
        # keep self._executor live until the end: _group_result may still
        # need to submit level-2 joins for groups whose callbacks lost the
        # race (it is consumed — shut down — in the finally below)
        ex = self._executor
        done = False
        try:
            for contig in self.plan.contigs:
                results = []
                for group in self.plan.contig_groups[contig]:
                    results.append(self._group_result(
                        prediction_files, contig, group))
                if not results:
                    joined = ("", "", "", "", "")
                else:
                    joined = alignment_stitch(results, self.cfg)
                if self.with_quality:
                    yield (contig, joined[3], joined[4])
                else:
                    yield (contig, joined[3])
            done = True
        finally:
            self._executor = None
            ex.shutdown(wait=done, cancel_futures=not done)

    def _reread_group(self, prediction_files: List[str], contig: str,
                      group: _Group):
        """Degraded path: classic store-reading worker for one group."""
        from helen_tpu_torch.io.prediction_store import list_region_keys

        by_key = {k: t for t in list_region_keys(prediction_files, contig)
                  for k in [t[1]]}
        key_group = [by_key[k] for k in group.keys]
        return _stitch_key_group(contig, key_group, self.cfg,
                                 self.with_quality)
