"""Packed image cache: contiguous batch-readable arrays.

Port of helen_tpu/io/packed.py on the port's own HDF5 module (io.hdf5). The
MarginPolish schema stores every image as its own HDF5 group with 6-8 small
datasets — reading it is dominated by per-dataset overhead and Python
dispatch. This module packs a set of image files into ONE cache file of
contiguous arrays:

  packed/images          uint8  (N, seq_length, feature_dim)
  packed/positions       int64  (N, seq_length, 3)
  packed/contig_ids      int32  (N,)          index into packed/contigs
  packed/contigs         bytes  (C,)          fixed-length, UTF-8
  packed/contig_start    int64  (N,)
  packed/contig_end      int64  (N,)
  packed/chunk_id        int32  (N,)
  packed/label_base      uint8  (N, seq_length)   (when labels present)
  packed/label_rle       uint8  (N, seq_length)
  packed/source_files    bytes  (F,)  + packed/source_mtimes float64 (F,)

A whole batch is then two slab reads (`images[a:b]`, `positions[a:b]`)
through the file's memory map instead of thousands of group opens. The
layout is helen_tpu's, in contiguous datasets and fixed-length strings (the
port's writer has no variable-length type), so helen_tpu reads the port's
caches, and the port reads helen_tpu's (chunked, variable-length strings):
a fresh cache either wrote is reused. The cache is
internal — pipeline inputs remain standard MarginPolish files;
`call_consensus(pack=True)` builds the cache next to the output dir and
validates it against source mtimes.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from helen_tpu_torch.config import IMAGE, ImageConfig
from helen_tpu_torch.io import hdf5
from helen_tpu_torch.io.images import ImageBatch, ImageRecord, MarginPolishDataset, prefetched
from helen_tpu_torch.obs import get_logger

log = get_logger("packed")

CHUNK_ROWS = 256  # images gathered in memory per slab write of pack_images


def _strings(values: Sequence[str]) -> np.ndarray:
    """Fixed-length byte strings, long enough for the longest value."""
    return np.array([v.encode() for v in values], dtype=bytes)


def pack_images(
    files: Sequence[str],
    cache_path: str,
    image_config: ImageConfig = IMAGE,
    with_labels: bool = False,
    indices: Optional[Sequence[int]] = None,
    dataset: Optional[MarginPolishDataset] = None,
) -> int:
    """Build a packed cache from MarginPolish files; returns image count.

    The cache is written to a temporary file that replaces ``cache_path``
    once complete (and is removed if the build fails). ``indices`` packs
    only that subset of the files' image index; the subset is recorded in
    the cache and checked by cache_is_fresh. Pass a prebuilt ``dataset``
    over the same files to skip re-indexing them.
    """
    ds = dataset if dataset is not None else MarginPolishDataset(
        files, image_config, with_labels=with_labels
    )
    idx = list(indices) if indices is not None else list(range(len(ds)))
    n = len(idx)
    if n == 0:
        raise ValueError("no images to pack")
    tmp = cache_path + f".tmp{os.getpid()}"
    try:
        _write_pack(tmp, ds, idx, image_config, files, with_labels,
                    indices is not None)
        os.replace(tmp, cache_path)
    finally:
        if os.path.exists(tmp):  # failed mid-pack: drop the orphan
            os.unlink(tmp)
    log.info("packed %d images into %s", n, cache_path)
    return n


def _write_pack(tmp, ds, idx, image_config, files, with_labels, subset):
    n = len(idx)
    L, F = image_config.seq_length, image_config.feature_dim
    contigs: List[str] = []
    contig_idx: dict = {}
    rows = min(CHUNK_ROWS, n)
    with hdf5.Writer(tmp) as out:
        g = out.create_group("packed")
        # positions stay int64: the unpacked path carries int64 coordinates
        # and int32 would silently wrap ref_position on >2^31-bp scaffolds
        images = g.create_dataset("images", (n, L, F), np.uint8)
        positions = g.create_dataset("positions", (n, L, 3), np.int64)
        contig_ids = np.zeros(n, dtype=np.int32)
        starts = np.zeros(n, dtype=np.int64)
        ends = np.zeros(n, dtype=np.int64)
        chunk_ids = np.zeros(n, dtype=np.int32)
        lb = g.create_dataset("label_base", (n, L), np.uint8) if with_labels else None
        lr = g.create_dataset("label_rle", (n, L), np.uint8) if with_labels else None
        # buffer a slab of rows and write it at once: one write per slab
        img_buf = np.zeros((rows, L, F), dtype=np.uint8)
        pos_buf = np.zeros((rows, L, 3), dtype=np.int64)
        lb_buf = np.zeros((rows, L), dtype=np.uint8) if with_labels else None
        lr_buf = np.zeros((rows, L), dtype=np.uint8) if with_labels else None

        def flush_slab(lo: int, hi: int) -> None:
            k = hi - lo
            images[lo:hi] = img_buf[:k]
            positions[lo:hi] = pos_buf[:k]
            if with_labels:
                lb[lo:hi] = lb_buf[:k]
                lr[lo:hi] = lr_buf[:k]

        slab_lo = 0
        for j, i in enumerate(idx):
            rec = ds.load(i)
            k = j - slab_lo
            img_buf[k] = rec.image
            pos_buf[k] = rec.position
            if rec.contig not in contig_idx:
                contig_idx[rec.contig] = len(contigs)
                contigs.append(rec.contig)
            contig_ids[j] = contig_idx[rec.contig]
            starts[j] = rec.contig_start
            ends[j] = rec.contig_end
            chunk_ids[j] = rec.chunk_id
            if with_labels:
                lb_buf[k] = rec.label_base
                lr_buf[k] = rec.label_rle
            if k + 1 == rows:
                flush_slab(slab_lo, j + 1)
                slab_lo = j + 1
        if slab_lo < n:
            flush_slab(slab_lo, n)
        _write_pack_meta(g, contigs, contig_ids, starts, ends, chunk_ids,
                         files, with_labels, image_config, idx, subset)


def _write_pack_meta(g, contigs, contig_ids, starts, ends, chunk_ids,
                     files, with_labels, image_config, idx, subset) -> None:
    """The cache's metadata + freshness signature (shared by the upfront
    pack_images build and the write-through PackTee)."""
    g["contig_ids"] = contig_ids
    g["contig_start"] = starts
    g["contig_end"] = ends
    g["chunk_id"] = chunk_ids
    g["contigs"] = _strings(contigs)
    g["source_files"] = _strings([os.path.abspath(f) for f in files])
    g["source_mtimes"] = np.array([os.path.getmtime(f) for f in files], dtype=np.float64)
    g["with_labels"] = np.int64(with_labels)
    g["image_shape"] = np.array(
        [image_config.seq_length, image_config.feature_dim], dtype=np.int64
    )
    if subset:
        g["source_indices"] = np.asarray(idx, dtype=np.int64)


class PackTee:
    """Write-through packed-cache builder: tee the consensus image stream
    into the cache DURING the run instead of a serial pre-read.

    Each image is read once; the cache writes ride a background thread
    (bounded queue, so a slow disk backpressures the feed instead of
    ballooning memory), and the finished cache equals a pack_images build
    array for array (same padded records, same metadata, same freshness
    signature) so the NEXT run slab-reads it.

    Contract: the feeder must deliver every index of the run exactly once,
    in order (the consensus drain loop with resume OFF — call_consensus
    keeps the upfront build for resume runs). ``finalize()`` publishes
    atomically via os.replace. A write error is not swallowed: the next
    ``add_batch`` or ``finalize`` removes the tmp file and raises it.
    """

    def __init__(self, cache_path: str, n: int,
                 image_config: ImageConfig = IMAGE,
                 files: Sequence[str] = (),
                 indices: Optional[Sequence[int]] = None):
        self.final = cache_path
        self.tmp = cache_path + f".tmp{os.getpid()}"
        self.cfg = image_config
        self.files = list(files)
        self.indices = list(indices) if indices is not None else None
        self.n = n
        self.closed = False
        self.error: Optional[BaseException] = None
        L, F = image_config.seq_length, image_config.feature_dim
        self._file = hdf5.Writer(self.tmp)
        g = self._group = self._file.create_group("packed")
        self._images = g.create_dataset("images", (n, L, F), np.uint8)
        self._positions = g.create_dataset("positions", (n, L, 3), np.int64)
        self._contigs: List[str] = []
        self._contig_idx: dict = {}
        self._contig_ids = np.zeros(n, dtype=np.int32)
        self._starts = np.zeros(n, dtype=np.int64)
        self._ends = np.zeros(n, dtype=np.int64)
        self._chunk_ids = np.zeros(n, dtype=np.int32)
        self._written = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._writer, daemon=True,
                                        name="pack-tee")
        self._thread.start()

    def add_batch(self, batch: ImageBatch) -> None:
        """Enqueue one drained batch (its first ``valid`` rows). Called from
        the drain loop; blocks only when the disk is 2+ batches behind.
        Raises the writer thread's error, if it had one (the cache is
        dropped)."""
        if self.error is not None:
            self.abandon()
            raise self.error
        if not self.closed:
            self._q.put(batch)

    def _writer(self) -> None:
        while True:
            b = self._q.get()
            if b is None:
                return
            if self.error is not None:
                continue  # drain remaining items so the feeder never blocks
            try:
                v = b.valid
                lo, hi = self._written, self._written + v
                if hi > self.n:
                    raise ValueError(f"packed-cache tee got {hi} images, expected {self.n}")
                self._images[lo:hi] = b.images[:v]
                self._positions[lo:hi] = np.stack([r.position for r in b.records])
                for j, r in enumerate(b.records):
                    ci = self._contig_idx.get(r.contig)
                    if ci is None:
                        ci = self._contig_idx[r.contig] = len(self._contigs)
                        self._contigs.append(r.contig)
                    self._contig_ids[lo + j] = ci
                    self._starts[lo + j] = r.contig_start
                    self._ends[lo + j] = r.contig_end
                    self._chunk_ids[lo + j] = r.chunk_id
                self._written = hi
            except Exception as exc:  # disk full, etc.: raised to the feeder
                self.error = exc

    def finalize(self) -> bool:
        """Publish the cache (atomic). Returns False, and removes the tmp
        file, if fewer than n images arrived; raises a write error after
        removing it."""
        self._q.put(None)
        self._thread.join()
        try:
            if self.error is not None:
                raise self.error
            if self._written != self.n:
                log.warning("packed-cache write-through incomplete "
                            "(%d/%d images); discarding", self._written, self.n)
                return False
            _write_pack_meta(self._group, self._contigs,
                             self._contig_ids, self._starts, self._ends,
                             self._chunk_ids, self.files, False, self.cfg,
                             self.indices, self.indices is not None)
            self._file.close()
            os.replace(self.tmp, self.final)
        finally:
            self.closed = True
            self._file.abandon()
            if os.path.exists(self.tmp):
                os.unlink(self.tmp)
        log.info("packed %d images into %s (write-through)", self.n, self.final)
        return True

    def abandon(self) -> None:
        """Drop the partial cache (run failed mid-stream)."""
        if self.closed:
            return
        self.error = self.error or RuntimeError("abandoned")
        self._q.put(None)
        self._thread.join()
        self.closed = True
        self._file.abandon()
        if os.path.exists(self.tmp):
            os.unlink(self.tmp)


def cache_is_fresh(
    cache_path: str,
    files: Sequence[str],
    indices: Optional[Sequence[int]] = None,
    image_config: ImageConfig = IMAGE,
    with_labels: bool = False,
) -> bool:
    """True when the cache exists, matches the source files' mtimes, was
    packed over the same image subset (``indices``; None = all images),
    carries labels if the consumer needs them, and was packed at the same
    image geometry. A cache this module cannot read is rebuilt."""
    if not os.path.exists(cache_path):
        return False
    try:
        with hdf5.File(cache_path) as f:
            g = f["packed"]
            srcs = [s.decode() for s in g["source_files"][()]]
            mtimes = list(g["source_mtimes"][()])
            cached_idx = g["source_indices"][()] if "source_indices" in g else None
            has_labels = bool(g["with_labels"][()] if "with_labels" in g
                              else "label_base" in g)
            shape = (tuple(g["image_shape"][()]) if "image_shape" in g
                     else g["images"].shape[1:])
            # PackedDataset must be able to read these: opening a dataset
            # raises on a layout or type io.hdf5 lacks
            for name in ("images", "contigs", "contig_ids", "contig_start",
                         "contig_end", "chunk_id",
                         *(("label_base", "label_rle") if with_labels else ())):
                g[name]
            pos_ok = g["positions"].dtype == np.int64
    except Exception:
        return False
    if not pos_ok:
        return False
    if with_labels and not has_labels:
        return False
    if tuple(shape) != (image_config.seq_length, image_config.feature_dim):
        return False
    want = [os.path.abspath(p) for p in files]
    if srcs != want:
        return False
    if (indices is None) != (cached_idx is None):
        return False
    if indices is not None and not np.array_equal(
        np.asarray(indices, dtype=np.int64), cached_idx
    ):
        return False
    return all(abs(os.path.getmtime(p) - m) < 1e-6 for p, m in zip(want, mtimes))


class PackedDataset:
    """Batch-granular reader over a packed cache."""

    # image_meta() reads from in-memory arrays — a full metadata pre-scan
    # (streaming stitch) is free here, unlike MarginPolishDataset's
    # per-image HDF5 reads
    CHEAP_META = True

    def __init__(self, cache_path: str, with_labels: bool = False):
        self.path = cache_path
        self.with_labels = with_labels
        self.file = hdf5.File(cache_path)
        g = self.file["packed"]
        self._images = g["images"]
        self._positions = g["positions"]
        self._lb = g["label_base"] if with_labels else None
        self._lr = g["label_rle"] if with_labels else None
        self.n = self._images.shape[0]
        self.contigs = [c.decode() for c in g["contigs"][()]]
        self.contig_ids = g["contig_ids"][()]
        self.contig_start = g["contig_start"][()]
        self.contig_end = g["contig_end"][()]
        self.chunk_id = g["chunk_id"][()]

    def __len__(self) -> int:
        return self.n

    def close(self) -> None:
        self.file.close()

    def image_meta(self, i: int) -> Tuple[str, int, int, int]:
        """(contig, contig_start, contig_end, chunk_id) for image ``i``
        without touching the image/position slabs."""
        return (
            self.contigs[self.contig_ids[i]],
            int(self.contig_start[i]),
            int(self.contig_end[i]),
            int(self.chunk_id[i]),
        )

    def read_batch(self, indices: np.ndarray) -> ImageBatch:
        indices = np.asarray(indices)
        # batches are sorted ranges in the common case: one slab read each
        if len(indices) and (np.diff(indices) == 1).all():
            rows = slice(int(indices[0]), int(indices[-1]) + 1)
        else:
            rows = indices
        images = self._images[rows]
        positions = self._positions[rows]
        lb = self._lb[rows] if self.with_labels else None
        lr = self._lr[rows] if self.with_labels else None
        records = [
            ImageRecord(
                contig=self.contigs[self.contig_ids[i]],
                contig_start=int(self.contig_start[i]),
                contig_end=int(self.contig_end[i]),
                chunk_id=int(self.chunk_id[i]),
                image=images[j],
                position=positions[j],
                filename=self.path,
                label_base=lb[j].astype(np.int64) if lb is not None else None,
                label_rle=lr[j].astype(np.int64) if lr is not None else None,
            )
            for j, i in enumerate(indices)
        ]
        return ImageBatch(
            records=records,
            images=images,
            valid=len(records),
            labels_base=lb.astype(np.int32) if lb is not None else None,
            labels_rle=lr.astype(np.int32) if lr is not None else None,
        )


def prefetch_iterator(it: Iterator, depth: int = 3) -> Iterator:
    """Run an iterator in a background thread with a bounded queue so slab
    reads overlap downstream compute (images.prefetched: the producer can
    never block forever on an abandoned consumer)."""
    stop = threading.Event()
    yield from prefetched(lambda: it, stop, depth)


def packed_batch_iterator(
    dataset: PackedDataset,
    batch_size: int,
    indices: Optional[Sequence[int]] = None,
    pad_final: bool = True,
) -> Iterator[ImageBatch]:
    """Stream batches from a packed cache with slab reads; ``pad_final``
    zero-pads the last batch to ``batch_size`` rows."""
    order = np.asarray(indices if indices is not None else np.arange(len(dataset)))
    for start in range(0, len(order), batch_size):
        chunk = order[start : start + batch_size]
        batch = dataset.read_batch(chunk)
        if pad_final and batch.valid < batch_size:
            pad = batch_size - batch.valid
            batch.images = np.concatenate(
                [batch.images, np.zeros((pad,) + batch.images.shape[1:], np.uint8)]
            )
            if batch.labels_base is not None:
                batch.labels_base = np.concatenate(
                    [batch.labels_base, np.zeros((pad, batch.labels_base.shape[1]), np.int32)]
                )
                batch.labels_rle = np.concatenate(
                    [batch.labels_rle, np.zeros((pad, batch.labels_rle.shape[1]), np.int32)]
                )
        yield batch
