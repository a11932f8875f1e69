"""The polish pipeline: consensus calling then stitching.

Port of helen_tpu/infer/polish.py on one process (the reference's
PolishInterface.polish_genome, PolishInterface.py:49-105): runs
call_consensus into a timestamped predictions directory inside the output
dir (``resume``: the newest one), then stitches the predictions into a
polished FASTA (``fastq``: a FASTQ with per-base qualities), reporting
per-stage elapsed time. By default the stitch streams: region merges run on
the stitch pool while consensus is still running (stitch.streaming,
byte-identical to the classic store-reading stitch).
"""
from __future__ import annotations

import os
from typing import Optional

from helen_tpu_torch.io.fasta import write_fasta, write_fastq
from helen_tpu_torch.io.prediction_store import list_contigs
from helen_tpu_torch.obs import StageTimer, get_logger
from helen_tpu_torch.stitch import Stitcher
from helen_tpu_torch.utils.filesystem import (
    ensure_output_dir,
    list_prediction_files,
    timestamped_dir,
)

log = get_logger("polish")


def perform_stitch(
    input_directory: str,
    output_dir: str,
    output_prefix: str = "HELEN_prediction",
    threads: int = 4,
    fastq: bool = False,
    executor=None,
) -> str:
    """Stitch all prediction files in a directory into one polished FASTA
    (reference StitchInterface.perform_stitch, StitchInterface.py:40-106).
    Returns the output path. ``executor``: optional pre-warmed pool from
    stitch.engine.prewarm_stitch_pool (ownership passes to the Stitcher)."""
    prediction_files = list_prediction_files(input_directory)
    if not prediction_files:
        raise FileNotFoundError(f"no prediction (*.hdf) files in {input_directory}")
    contigs = list_contigs(prediction_files)
    log.info("stitching %d contigs from %d prediction files", len(contigs),
             len(prediction_files))

    ensure_output_dir(output_dir)
    out_path = os.path.join(output_dir, output_prefix + (".fq" if fastq else ".fa"))
    stitcher = Stitcher(threads=threads, with_quality=fastq, executor=executor)
    return _write_polished(out_path,
                           stitcher.stitch_iter(prediction_files, contigs),
                           len(contigs), fastq)


def _write_polished(out_path: str, rows, n_contigs: int, fastq: bool) -> str:
    """Shared output protocol of the classic and streamed stitch stages."""

    def records():
        for i, row in enumerate(rows):
            log.info("%04d/%04d: finished %s, polished length %d",
                     i + 1, n_contigs, row[0], len(row[1]))
            yield row

    n = write_fastq(out_path, records()) if fastq \
        else write_fasta(out_path, records())
    log.info("wrote %d contigs to %s", n, out_path)
    return out_path


def _finish_streamed(sink, pred_dir: str, output_dir: str,
                     output_prefix: str, fastq: bool) -> str:
    """Write the FASTA from a completed streaming-stitch sink: only the
    in-order contig joins remain."""
    prediction_files = list_prediction_files(pred_dir)
    out_path = os.path.join(output_dir,
                            output_prefix + (".fq" if fastq else ".fa"))
    n_contigs = len(sink.plan.contigs)
    log.info("stitching %d contigs (streamed) from %d prediction files",
             n_contigs, len(prediction_files))
    return _write_polished(out_path, sink.finish_iter(prediction_files),
                           n_contigs, fastq)


def polish(
    image_dir: str,
    model_path: str,
    output_dir: str = "./output",
    batch_size: int = 512,
    num_workers: int = 8,
    threads: int = 4,
    output_prefix: str = "HELEN_prediction",
    resume: bool = False,
    profile_dir: Optional[str] = None,
    backend: Optional[str] = None,
    pack: bool = False,
    num_writers: int = 1,
    pipeline_depth: int = 2,
    fastq: bool = False,
    stream_stitch: bool = True,
    device: str = "cuda",
    stage_timer: Optional[StageTimer] = None,
) -> str:
    """Full polish: images -> consensus -> stitch -> polished FASTA path.

    ``fastq=True`` stores per-column qualities at consensus and writes
    <prefix>.fq with per-base phred qualities. ``resume`` continues the
    newest ``predictions_*`` directory of ``output_dir``. ``pack`` keeps its
    image cache in ``output_dir`` itself, so later runs reuse it;
    ``num_writers`` as in call_consensus.

    ``stream_stitch`` (default on) overlaps stitching with consensus; it
    falls back to the classic store-reading stitch under ``resume`` (the
    stores hold records this run never sees), when ``threads <= 1``, past
    PRESCAN_IMAGE_LIMIT images unless the dataset's metadata is in memory
    (``--pack``), when the metadata pre-scan fails, or on any mid-stream
    failure. ``stage_timer`` receives the polish stages (call_consensus,
    stitch) and the consensus stages inside them (image read, device
    transfer, submit, read, store write, the streaming stitch's feed).
    ``backend`` goes to
    call_consensus as it is (``"pallas_fast"``, what ``--fast`` sets, is the
    fast tier).
    """
    from helen_tpu_torch.infer.consensus import call_consensus, resolve_device
    from helen_tpu_torch.stitch.engine import prewarm_stitch_pool

    resolve_device(device)  # fail before the stitch pool spawns
    timer = stage_timer if stage_timer is not None else StageTimer()
    output_dir = ensure_output_dir(output_dir)
    pred_dir = None
    if resume:
        # the newest predictions dir holds the interrupted run's stores
        existing = sorted(d for d in os.listdir(output_dir)
                          if d.startswith("predictions_")
                          and os.path.isdir(os.path.join(output_dir, d)))
        if existing:
            pred_dir = os.path.join(output_dir, existing[-1])
            log.info("resuming into %s", pred_dir)
    if pred_dir is None:
        pred_dir = timestamped_dir(output_dir, "predictions")
    # pre-warm the stitch pool BEFORE consensus: the worker spawn + imports
    # overlap the device-bound consensus stage
    stitch_pool = prewarm_stitch_pool(threads)

    sink = None
    sink_factory = None
    if stream_stitch and not resume and stitch_pool is not None:
        def sink_factory(dataset, indices, _pool=stitch_pool):
            nonlocal sink
            from helen_tpu_torch.config import STITCH
            from helen_tpu_torch.stitch.streaming import (
                PRESCAN_IMAGE_LIMIT,
                StreamingStitcher,
                build_stream_plan,
            )

            n = len(dataset) if indices is None else len(indices)
            if n > PRESCAN_IMAGE_LIMIT and not getattr(dataset, "CHEAP_META", False):
                # the unpacked pre-scan is ~4 serial HDF5 reads per image —
                # at this scale it would stall startup for minutes; the
                # packed cache's metadata is in memory
                log.info("streaming stitch off: %d images without --pack "
                         "(metadata pre-scan would stall startup; add --pack "
                         "to stream at this scale)", n)
                return None
            try:
                plan = build_stream_plan(dataset, indices, threads, STITCH)
            except Exception as exc:  # metadata pre-scan failed: classic path
                log.warning("stream-stitch pre-scan failed (%s); using the "
                            "classic stitch stage", exc)
                return None
            sink = StreamingStitcher(plan, STITCH, with_quality=fastq,
                                     executor=_pool)
            return sink
    try:
        with timer.stage("call_consensus"):
            call_consensus(
                image_dir=image_dir,
                model_path=model_path,
                output_dir=pred_dir,
                batch_size=batch_size,
                num_workers=num_workers,
                resume=resume,
                profile_dir=profile_dir,
                backend=backend,
                pack=pack,
                num_writers=num_writers,
                pipeline_depth=pipeline_depth,
                qualities=fastq,
                stream_sink_factory=sink_factory,
                device=device,
                stage_timer=timer,
                # the cache in the stable parent, not the per-run timestamped
                # predictions dir, so every later polish reuses it
                cache_dir=output_dir,
            )
        with timer.stage("stitch"):
            if sink is not None and sink.ready():
                fasta = _finish_streamed(sink, pred_dir, output_dir,
                                         output_prefix, fastq)
                stitch_pool = None  # consumed by finish_iter
            else:
                if sink is not None:
                    # mid-stream failure: reclaim the pool and re-read the
                    # (complete) store classically
                    stitch_pool = sink.abort()
                fasta = perform_stitch(pred_dir, output_dir, output_prefix,
                                       threads, fastq=fastq,
                                       executor=stitch_pool)
                stitch_pool = None  # ownership passed and consumed
    finally:
        if stitch_pool is not None:  # consensus failed before stitch ran
            stitch_pool.shutdown(wait=False, cancel_futures=True)
    log.info("polish complete:\n%s", timer.report())
    return fasta
