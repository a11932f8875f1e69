"""Consensus calling: batched GPU inference over MarginPolish images.

Port of helen_tpu/infer/consensus.py on one process and one device: each
batch of uint8 images runs the whole 19-window vote + argmax
(models.transducer.consensus_labels) on the device, images stream in through
a thread-pool prefetcher, and per-image labels are written to the resumable
HDF5 prediction store (and, under polish, fed to the streaming stitch).

Single-host I/O paths as in helen_tpu: the packed image cache (``pack``),
the writer pool (``num_writers``), resume into existing stores (``resume``)
and per-column qualities (``qualities``).

The main loop keeps ``pipeline_depth`` batches in flight: a background
thread copies batch k+1 to the device on a side stream (from pinned memory)
while the device computes batch k and the host drains batch k-1.
"""
from __future__ import annotations

import glob
import itertools
import os
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from helen_tpu_torch.config import IMAGE, WINDOW
from helen_tpu_torch.io.checkpoint import load_model_any
from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator, prefetched
from helen_tpu_torch.io.prediction_store import PredictionStore, _chunk_keys, store_files
from helen_tpu_torch.obs import StageTimer, Throughput, get_logger, profile_trace
from helen_tpu_torch.utils.filesystem import ensure_output_dir, list_image_files

log = get_logger("consensus")

DEVICES = ("cuda", "cpu")


def resolve_device(name: str = "cuda"):
    """``"cuda"`` -> the current CUDA device, raising when there is none
    (it never carries on on the CPU); ``"cpu"`` -> the CPU."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda (the default) needs a CUDA GPU and "
                           "none is visible; pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class ConsensusStep:
    """Consensus on one device with async transfer/submit/read.

    ``transfer`` copies a batch to the device (on CUDA: pinned host memory,
    a side stream, and an event the compute stream waits on); ``submit``
    enqueues the vote + argmax and the device->host copy of the labels and
    returns at once; ``read`` waits for that copy and returns numpy labels.
    """

    def __init__(self, params, device, backend: Optional[str] = None,
                 qualities: bool = False):
        import torch

        from helen_tpu_torch.io.checkpoint import params_to_torch
        from helen_tpu_torch.models.transducer import (
            FAST_BACKENDS,
            engaged_kernel,
            model_geometry,
            resolve_backend,
            set_fp32_precision,
        )

        set_fp32_precision()
        self.device = torch.device(device)
        self.backend = resolve_backend(backend, self.device, params)
        # the fast tier's bf16 weight copies, made once for the whole run
        self.params = params_to_torch(params, self.device,
                                      fast=self.backend in FAST_BACKENDS)
        self.kernels = engaged_kernel(self.params, self.backend)
        self.qualities = qualities
        log.info("consensus device: %s, backend: %s (kernels: %s)", self.device,
                 self.backend, self.kernels)
        if self.device.type == "cuda" and torch.cuda.device_count() > 1:
            log.warning("%d GPUs visible: consensus runs on %s only (multi-GPU "
                        "data parallelism is not yet ported)",
                        torch.cuda.device_count(), self.device)
        # Packed label readback: when both heads' label alphabets fit one
        # byte (flagship: base 5 x rle 11 = 55 codes), the device returns a
        # single (B, L) uint8 array ``base * num_rle + rle`` and ``read``
        # decodes it with an exact divmod — half the device->host bytes.
        # With qualities the phred array comes back beside it (3 -> 2 arrays).
        geom = model_geometry(self.params)
        self._pack_nr: Optional[int] = None
        if geom.num_base_classes * geom.num_rle_classes <= 256:
            self._pack_nr = geom.num_rle_classes
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def transfer(self, images_u8: np.ndarray):
        """Host->device copy of one batch; call_consensus runs it on a
        background thread. On CUDA the copy is issued on a side stream from
        pinned memory and returns ``(device tensor, ready event)``."""
        import torch

        host = torch.from_numpy(images_u8)
        if self._copy_stream is None:
            return host
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def submit(self, images):
        """Enqueue one batch (numpy, or what ``transfer`` returned)."""
        import torch

        from helen_tpu_torch.models.transducer import (
            consensus_labels,
            consensus_labels_and_quality,
        )

        if isinstance(images, np.ndarray):
            images = self.transfer(images)
        if self._copy_stream is not None:
            images, ready = images
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            # the copy stream allocated this tensor; keep its memory from
            # being reused until the compute stream is done with it
            images.record_stream(compute)
        with torch.no_grad():
            if self.qualities:
                base, rle, q = consensus_labels_and_quality(self.params, images, WINDOW,
                                                            backend=self.backend)
            else:
                base, rle = consensus_labels(self.params, images, WINDOW,
                                             backend=self.backend)
            outs = ((base * self._pack_nr + rle,) if self._pack_nr is not None
                    else (base, rle))
            if self.qualities:
                outs = outs + (q,)
        if self._copy_stream is None:
            return outs, None
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                     for o in outs)
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def read(self, handle) -> Tuple[np.ndarray, ...]:
        """Wait for one submitted batch; returns ``(base, rle)`` uint8, plus
        the phred array with ``qualities``."""
        outs, done = handle
        if done is not None:
            done.synchronize()
        arrays = [o.numpy() for o in outs]
        if self._pack_nr is not None:
            packed = arrays[0]
            base = packed // np.uint8(self._pack_nr)
            rle = packed - base * np.uint8(self._pack_nr)
            arrays = [base.astype(np.uint8, copy=False), rle.astype(np.uint8, copy=False),
                      *arrays[1:]]
        return tuple(arrays)

    def __call__(self, images_u8: np.ndarray) -> Tuple[np.ndarray, ...]:
        return self.read(self.submit(images_u8))


def _publish_partial_siblings(paths: Sequence[str]) -> None:
    """Under resume, a shard a killed earlier run left unpublished (another
    pool size's ``<shard>.partial`` and its journal) is recovered and
    published, so its records count once and stitch reads them."""
    for path in paths:
        if os.path.exists(path + ".journal") or os.path.exists(path + ".partial"):
            log.info("publishing the records a killed run left in %s", path)
            PredictionStore(path, "a").close()


def call_consensus(
    image_dir: Optional[str] = None,
    model_path: str = "",
    output_dir: str = "./output",
    batch_size: int = 512,
    num_workers: int = 8,
    image_files: Optional[Sequence[str]] = None,
    output_prefix: str = "helen_predictions",
    resume: bool = False,
    profile_dir: Optional[str] = None,
    backend: Optional[str] = None,
    pack: bool = False,
    num_writers: int = 1,
    qualities: bool = False,
    cache_dir: Optional[str] = None,
    stage_timer: Optional[StageTimer] = None,
    pipeline_depth: int = 2,
    stream_sink_factory=None,
    device: str = "cuda",
) -> List[str]:
    """Run consensus calling over a directory of MarginPolish images.

    Writes ``<output_dir>/<output_prefix>_0.hdf`` (rank 0 of a one-process
    job) and returns the store's files (a resumed run's new records go to
    another file of the store: io.prediction_store.PredictionStore).
    ``device`` is ``"cuda"`` (default; raises without a GPU) or ``"cpu"``;
    ``backend`` is resolved by models.transducer.resolve_backend
    (``"pallas_fast"``: the fast tier).

    ``num_writers > 1`` fans writes out to that many writer PROCESSES, each
    owning ``<prefix>_0_w<k>.hdf`` (io.writer_pool); stitch merges the
    shards. ``resume`` continues the stores in ``output_dir``: every record
    already stored, in any shard layout an earlier run used, is skipped,
    and a batch whose records are all stored is not computed. ``qualities``
    stores a per-column phred array beside the labels (for ``stitch
    --fastq``). ``pack`` builds (or reuses) a packed contiguous cache of the
    images in ``cache_dir`` (default ``output_dir``) for slab-read streaming
    (io.packed): a stale cache on a fresh run builds WRITE-THROUGH (a tee
    thread writes the images into it as batches drain), on a resumed run
    upfront (skipped batches would leave holes). A failed tee, pack or
    writer raises.

    ``stream_sink_factory`` (polish's streaming-stitch hook) is called once
    with the resolved ``(dataset, indices)`` and may return a sink whose
    ``add(rec, bases, rles, quals)`` then receives every record the
    prediction store accepts, in stream order, as batches drain.
    """
    dev = resolve_device(device)
    files = list(image_files) if image_files is not None else list_image_files(image_dir)
    if not files:
        raise FileNotFoundError(f"no image files found in {image_dir!r}")
    ensure_output_dir(output_dir)
    shard_id = 0  # rank 0 of a one-process job
    out_path = os.path.join(output_dir, f"{output_prefix}_{shard_id}.hdf")

    params, meta = load_model_any(model_path)
    log.info("model loaded from %s (epochs=%s)", model_path, meta.get("epochs"))

    dataset = None
    packed_ds = None
    pack_tee = None
    if pack:
        from helen_tpu_torch.io.packed import (
            PackedDataset,
            PackTee,
            cache_is_fresh,
            pack_images,
        )

        # cache_dir lets polish() keep the cache OUTSIDE its per-run
        # timestamped predictions dir so later runs reuse it
        cache_path = os.path.join(ensure_output_dir(cache_dir or output_dir),
                                  "images_cache.h5")
        if cache_is_fresh(cache_path, files):
            packed_ds = dataset = PackedDataset(cache_path)
        elif resume:
            # resume skips already-stored batches, which would leave holes
            # in a write-through cache: build it upfront
            log.info("building packed image cache %s", cache_path)
            pack_images(files, cache_path, IMAGE)
            packed_ds = dataset = PackedDataset(cache_path)
        else:
            dataset = MarginPolishDataset(files, IMAGE)
            if len(dataset) > 0:  # 0 falls through to the no-images error
                log.info("building packed image cache %s during this run "
                         "(write-through)", cache_path)
                pack_tee = PackTee(cache_path, len(dataset), IMAGE, files)
    else:
        dataset = MarginPolishDataset(files, IMAGE)
    if len(dataset) == 0:
        raise ValueError(f"no images found in {len(files)} input files")
    log.info("%d images across %d files", len(dataset), len(files))

    stream_sink = None
    if stream_sink_factory is not None:
        stream_sink = stream_sink_factory(dataset, None)
        if stream_sink is not None:
            log.info("streaming stitch: overlapping region merges with "
                     "consensus")

    step = ConsensusStep(params, dev, backend, qualities)

    if num_writers > 1:
        out_paths = [os.path.join(output_dir, f"{output_prefix}_{shard_id}_w{k}.hdf")
                     for k in range(num_writers)]
    else:
        out_paths = [out_path]
    # resume must skip chunks no matter which shard layout a previous run
    # used (a different --writers count, or the single-writer file): the
    # files of stores outside this run's own contribute dedupe keys only
    siblings = set()
    if resume:
        for name in (f"{output_prefix}_{shard_id}.hdf", f"{output_prefix}_{shard_id}.r*.hdf",
                     f"{output_prefix}_{shard_id}_w*.hdf"):
            siblings.update(glob.glob(os.path.join(output_dir, name)))
            siblings.update(p[:-len(".partial")] for p in
                            glob.glob(os.path.join(output_dir, name + ".partial")))
    extra = sorted(siblings - {f for p in out_paths for f in store_files(p)})
    _publish_partial_siblings(extra)
    if num_writers > 1:
        from helen_tpu_torch.io.writer_pool import PredictionWriterPool

        store_cm = PredictionWriterPool(out_paths, "a" if resume else "w",
                                        extra_key_files=extra)
    else:
        store_cm = PredictionStore(out_path, "a" if resume else "w")
        for p in extra:
            store_cm.preload_chunk_keys(_chunk_keys(p))

    timer = stage_timer if stage_timer is not None else StageTimer()
    windows = Throughput(unit="windows")
    n_windows = WINDOW.num_windows(IMAGE.seq_length)
    written = skipped = 0
    # skipped_whole is owned by the producer thread, ``skipped`` (records of
    # computed batches already stored) by the main thread in drain()
    skipped_whole = 0

    try:
        with store_cm as store, profile_trace(profile_dir):
            indices = list(range(len(dataset)))
            windows.start()
            total_batches = (len(indices) + batch_size - 1) // batch_size

            def drain(pending) -> None:
                nonlocal written, skipped
                b, handle = pending
                with timer.stage("device_read"):
                    out = step.read(handle)
                base_labels, rle_labels = out[0], out[1]
                quals = out[2] if qualities else [None] * len(b.records)
                windows.add(b.valid * n_windows)
                if pack_tee is not None:
                    # write-through cache build: blocks only when the disk
                    # falls 2+ batches behind (that backpressure is this
                    # stage's time)
                    with timer.stage("pack_tee"):
                        pack_tee.add_batch(b)
                with timer.stage("write"):
                    # first-write-wins: records already stored (resume) are
                    # skipped, not written
                    accepted = [j for j, rec in enumerate(b.records)
                                if store.write_prediction(
                                    rec.contig, rec.contig_start, rec.contig_end,
                                    rec.chunk_id, rec.position, base_labels[j],
                                    rle_labels[j], quals[j])]
                written += len(accepted)
                skipped += len(b.records) - len(accepted)
                if stream_sink is not None:
                    with timer.stage("stream_stitch"):
                        for j in accepted:
                            stream_sink.add(b.records[j], base_labels[j], rle_labels[j],
                                            quals[j])

            # no zero-padded tail batch: the kernels mask a ragged batch edge
            if packed_ds is not None:
                from helen_tpu_torch.io.packed import packed_batch_iterator, prefetch_iterator

                batch_iter = prefetch_iterator(packed_batch_iterator(
                    packed_ds, batch_size, indices=indices, pad_final=False))
            else:
                batch_iter = batched_image_iterator(dataset, batch_size, num_workers,
                                                    indices=indices, pad_final=False)

            def todo_batches():
                nonlocal skipped_whole
                it = iter(batch_iter)
                for abs_bi in itertools.count():
                    # the seconds the pipeline waits on the image reader
                    with timer.stage("image_read"):
                        batch = next(it, None)
                    if batch is None:
                        return
                    # stored chunks only ever shrink this run's todo set
                    # before the loop starts (each image appears once in the
                    # stream), so checking from this thread races with
                    # nothing that changes the answer
                    if resume and all(store.has_chunk(r.contig, r.contig_start,
                                                      r.contig_end, r.chunk_id)
                                      for r in batch.records):
                        skipped_whole += len(batch.records)
                        continue
                    # a partly stored batch runs whole; drain() counts its
                    # stored records as skipped
                    yield abs_bi, batch

            def transferred():
                for abs_bi, batch in todo_batches():
                    with timer.stage("device_transfer"):
                        dev_images = step.transfer(batch.images)
                    yield abs_bi, batch, dev_images

            depth = max(1, pipeline_depth)
            in_flight: deque = deque()
            last_flush = time.monotonic()
            stop_evt = threading.Event()
            for bi, (abs_bi, batch, dev_images) in enumerate(
                    prefetched(transferred, stop_evt, depth)):
                with timer.stage("device_submit"):
                    handle = step.submit(dev_images)
                in_flight.append((batch, handle))
                if len(in_flight) > depth:
                    drain(in_flight.popleft())
                if bi % 10 == 0:
                    log.info("batch %d/%d  |  %s", abs_bi + 1, total_batches, windows)
                # flush so a hard kill leaves what --resume needs (time-based
                # too: at large batch sizes ten batches can be minutes of work)
                if bi % 10 == 0 or time.monotonic() - last_flush > 60:
                    with timer.stage("flush"):
                        store.flush()
                    last_flush = time.monotonic()
            while in_flight:
                drain(in_flight.popleft())
            windows.stop()
            if pack_tee is not None:
                with timer.stage("pack_tee"):
                    if not pack_tee.finalize():
                        raise RuntimeError("the packed-cache tee did not receive every "
                                           "image of the run")
    finally:
        if pack_tee is not None and not pack_tee.closed:
            pack_tee.abandon()  # failed mid-run: drop the partial cache
    if packed_ds is not None:
        packed_ds.close()  # its reader thread has finished

    skipped += skipped_whole  # the producer thread has exited by now
    log.info("consensus done: %d images written, %d skipped (already stored), %s",
             written, skipped, windows)
    log.info("stage timings:\n%s", timer.report())
    return [f for p in out_paths for f in store_files(p)]
