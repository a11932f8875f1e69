"""Consensus calling: batched GPU inference over MarginPolish images.

Port of helen_tpu/infer/consensus.py on one process and one device: each
batch of uint8 images runs the whole 19-window vote + argmax
(models.transducer.consensus_labels) on the device, images stream in through
a thread-pool prefetcher, and per-image labels are written to the resumable
HDF5 prediction store (and, under polish, fed to the streaming stitch).

The main loop keeps ``pipeline_depth`` batches in flight: a background
thread copies batch k+1 to the device on a side stream (from pinned memory)
while the device computes batch k and the host drains batch k-1.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from helen_tpu_torch.config import IMAGE, WINDOW
from helen_tpu_torch.io.checkpoint import load_model_any
from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator, prefetched
from helen_tpu_torch.io.prediction_store import PredictionStore
from helen_tpu_torch.obs import StageTimer, Throughput, get_logger, profile_trace
from helen_tpu_torch.utils.filesystem import ensure_output_dir, list_image_files

log = get_logger("consensus")

DEVICES = ("cuda", "cpu")


def not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to helen_tpu_torch "
                               "(ROADMAP.md, queue A); use helen_tpu")


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

    def __init__(self, params, device, backend: Optional[str] = None):
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

        from helen_tpu_torch.models.transducer import consensus_labels

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
            base, rle = consensus_labels(self.params, images, WINDOW,
                                         backend=self.backend)
            outs = ((base * self._pack_nr + rle,) if self._pack_nr is not None
                    else (base, rle))
        if self._copy_stream is None:
            return outs, None
        host = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                     for o in outs)
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def read(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for one submitted batch; returns ``(base, rle)`` uint8."""
        outs, done = handle
        if done is not None:
            done.synchronize()
        arrays = [o.numpy() for o in outs]
        if self._pack_nr is not None:
            packed = arrays[0]
            base = packed // np.uint8(self._pack_nr)
            rle = packed - base * np.uint8(self._pack_nr)
            return base.astype(np.uint8, copy=False), rle.astype(np.uint8, copy=False)
        return arrays[0], arrays[1]

    def __call__(self, images_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.read(self.submit(images_u8))


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
    stage_timer: Optional[StageTimer] = None,
    pipeline_depth: int = 2,
    stream_sink_factory=None,
    device: str = "cuda",
) -> List[str]:
    """Run consensus calling over a directory of MarginPolish images.

    Writes ``<output_dir>/<output_prefix>_0.hdf`` (rank 0 of a one-process
    job) and returns ``[that path]``. ``device`` is ``"cuda"`` (default;
    raises without a GPU) or ``"cpu"``; ``backend`` is resolved by
    models.transducer.resolve_backend (``"pallas_fast"``: the fast tier).

    ``stream_sink_factory`` (polish's streaming-stitch hook) is called once
    with the resolved ``(dataset, indices)`` and may return a sink whose
    ``add(rec, bases, rles, quals)`` then receives every record the
    prediction store accepts, in stream order, as batches drain.

    ``resume``, ``pack``, ``num_writers > 1`` and ``qualities`` are helen_tpu
    paths not ported yet; they raise.
    """
    for flag, on in (("--resume", resume), ("--pack", pack),
                     ("--writers > 1", num_writers > 1),
                     ("--qualities/--fastq", qualities)):
        if on:
            raise not_yet_ported(flag)
    dev = resolve_device(device)
    files = list(image_files) if image_files is not None else list_image_files(image_dir)
    if not files:
        raise FileNotFoundError(f"no image files found in {image_dir!r}")
    ensure_output_dir(output_dir)
    shard_id = 0  # rank 0 of a one-process job
    out_path = os.path.join(output_dir, f"{output_prefix}_{shard_id}.hdf")

    params, meta = load_model_any(model_path)
    log.info("model loaded from %s (epochs=%s)", model_path, meta.get("epochs"))

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

    step = ConsensusStep(params, dev, backend)

    timer = stage_timer if stage_timer is not None else StageTimer()
    windows = Throughput(unit="windows")
    n_windows = WINDOW.num_windows(IMAGE.seq_length)
    written = skipped = 0

    with PredictionStore(out_path, "w") as store, profile_trace(profile_dir):
        indices = list(range(len(dataset)))
        windows.start()
        total_batches = (len(indices) + batch_size - 1) // batch_size

        def drain(pending) -> None:
            nonlocal written, skipped
            b, handle = pending
            with timer.stage("device_read"):
                base_labels, rle_labels = step.read(handle)
            windows.add(b.valid * n_windows)
            with timer.stage("write"):
                for j, rec in enumerate(b.records):
                    wrote = store.write_prediction(
                        rec.contig, rec.contig_start, rec.contig_end, rec.chunk_id,
                        rec.position, base_labels[j], rle_labels[j], None,
                    )
                    # first-write-wins: a duplicate record counts as skipped
                    if wrote:
                        written += 1
                        if stream_sink is not None:
                            stream_sink.add(rec, base_labels[j], rle_labels[j],
                                            None)
                    else:
                        skipped += 1

        # no zero-padded tail batch: the kernels mask a ragged batch edge
        batch_iter = batched_image_iterator(dataset, batch_size, num_workers,
                                            indices=indices, pad_final=False)

        def transferred():
            for abs_bi, batch in enumerate(batch_iter):
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
            # flush so a hard kill leaves a readable store (time-based too:
            # at large batch sizes ten batches can be minutes of work)
            if bi % 10 == 0 or time.monotonic() - last_flush > 60:
                with timer.stage("flush"):
                    store.flush()
                last_flush = time.monotonic()
        while in_flight:
            drain(in_flight.popleft())
        windows.stop()

    log.info("consensus done: %d images written, %d skipped (duplicates), %s",
             written, skipped, windows)
    log.info("stage timings:\n%s", timer.report())
    return [out_path]
