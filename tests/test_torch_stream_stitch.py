"""The port's streaming stitch (helen_tpu_torch/stitch/streaming.py) on the
two paths that must hand the stitch to the prediction store:

* a record for a region that has already sealed takes the plan-mismatch
  path (the stream breaks at once, as for a record the plan never
  predicted);
* the label bytes buffered in regions not yet sealed have a bound
  (``StreamingStitcher.UNSEALED_BYTES_LIMIT``); past it the stream breaks
  and drops every buffer.

Either way the FASTA is the store stitch's, byte for byte. Regions of three
chunks each (region_cols=2500 over 1000-column images) keep regions open
across records.
"""
import concurrent.futures
import os

import numpy as np
import pytest

from torch_port_fixtures import golden

N_CHUNKS = 3


class _InlinePool:
    """Runs submits synchronously with real Futures."""

    def submit(self, fn, *a, **k):
        f = concurrent.futures.Future()
        f.set_result(fn(*a, **k))
        return f

    def shutdown(self, **k):
        pass


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    d = tmp_path_factory.mktemp("stream") / "images"
    d.mkdir()
    write_image_file(str(d / "img.h5"), {"ctgA": random_sequence(7000, seed=3),
                                         "ctgB": random_sequence(4000, seed=4)},
                     region_cols=2500, overlap_cols=80, noise=0.2, seed=5)
    return str(d)


def _dataset(image_dir):
    from helen_tpu_torch.io.images import MarginPolishDataset

    return MarginPolishDataset(sorted(os.path.join(image_dir, f)
                                      for f in os.listdir(image_dir)))


def _labels(ds):
    rng = np.random.default_rng(6)
    out = []
    for i in range(len(ds)):
        n = ds.load(i).position.shape[0]
        out.append((rng.integers(0, 5, n).astype(np.uint8),
                    rng.integers(0, 11, n).astype(np.uint8)))
    return out


def _feed(ds, labels, store_dir, sink=None):
    """Every record into a prediction store and, as polish does, each one
    the store accepted into the sink (if any)."""
    from helen_tpu_torch.io.prediction_store import PredictionStore

    with PredictionStore(os.path.join(store_dir, "pred_0.hdf"), "w") as store:
        for i in range(len(ds)):
            rec = ds.load(i)
            bases, rles = labels[i]
            assert store.write_prediction(rec.contig, rec.contig_start, rec.contig_end,
                                          rec.chunk_id, rec.position, bases, rles)
            if sink is not None:
                sink.add(rec, bases, rles)


def _streamed_and_classic(ds, labels, tmp_path):
    """The FASTA text of a clean streamed stitch and of the store stitch."""
    from helen_tpu_torch.config import STITCH
    from helen_tpu_torch.infer.polish import perform_stitch
    from helen_tpu_torch.stitch.streaming import StreamingStitcher, build_stream_plan

    d = str(tmp_path / "clean")
    os.makedirs(d)
    sink = StreamingStitcher(build_stream_plan(ds, None, 2, STITCH), STITCH,
                             executor=_InlinePool())
    _feed(ds, labels, d, sink)
    assert sink.ready()
    rows = list(sink.finish_iter([os.path.join(d, "pred_0.hdf")]))
    with open(perform_stitch(d, d, "classic", threads=1)) as f:
        classic = f.read()
    return "".join(f">{c}\n{s}\n" for c, s in rows), classic


def test_regions_span_several_chunks(images):
    ds = _dataset(images)
    per_region = {}
    for i in range(len(ds)):
        c, s, e, k = ds.image_meta(i)
        per_region.setdefault((c, s, e), set()).add(k)
    assert max(len(v) for v in per_region.values()) == N_CHUNKS


def test_record_for_a_sealed_region_breaks_the_stream(images, tmp_path):
    """A second record for a region that sealed is a plan mismatch: the
    stream breaks at once and ships nothing more; the FASTA comes from the
    store, byte-identical to a clean stream's."""
    from helen_tpu_torch.config import STITCH
    from helen_tpu_torch.infer.polish import perform_stitch
    from helen_tpu_torch.stitch.streaming import StreamingStitcher, build_stream_plan

    ds = _dataset(images)
    labels = _labels(ds)
    streamed, classic = _streamed_and_classic(ds, labels, tmp_path)
    assert streamed == classic

    plan = build_stream_plan(ds, None, 2, STITCH)
    sink = StreamingStitcher(plan, STITCH, executor=_InlinePool())
    first = ds.load(0)
    key = f"{first.contig}-{first.contig_start}-{first.contig_end}"
    region = plan.regions[(first.contig, key)]
    sealing = [i for i in range(len(ds))
               if (ds.load(i).contig, ds.load(i).contig_start) ==
               (first.contig, first.contig_start)]
    assert len(sealing) == N_CHUNKS
    for i in sealing:
        sink.add(ds.load(i), *labels[i])
    assert region.received == region.expected and not region.chunks  # sealed, shipped
    assert not sink.broken
    sink.add(first, *labels[0])  # the late record
    assert sink.broken and not sink.ready()
    assert all(not r.chunks for r in plan.regions.values())

    d = str(tmp_path / "late")
    os.makedirs(d)
    _feed(ds, labels, d, sink)  # the rest: the store takes them, the sink ignores them
    assert sink.broken and not sink.ready()
    with open(perform_stitch(d, d, "classic", threads=1)) as f:
        assert f.read() == streamed


@pytest.mark.parametrize("limit,breaks", [(1, True), (1 << 30, False)])
def test_unsealed_bytes_have_a_bound(images, tmp_path, limit, breaks):
    """Past UNSEALED_BYTES_LIMIT bytes in unsealed regions the stream breaks
    and drops those buffers; within it the stream runs to the end. The
    FASTA is the store stitch's either way."""
    from helen_tpu_torch.config import STITCH
    from helen_tpu_torch.infer.polish import perform_stitch
    from helen_tpu_torch.stitch.streaming import StreamingStitcher, build_stream_plan

    ds = _dataset(images)
    labels = _labels(ds)
    plan = build_stream_plan(ds, None, 2, STITCH)
    sink = StreamingStitcher(plan, STITCH, executor=_InlinePool())
    sink.UNSEALED_BYTES_LIMIT = limit
    first = ds.load(0)
    sink.add(first, *labels[0])  # one chunk of a three-chunk region
    assert sink.broken is breaks
    assert all(not r.chunks for r in plan.regions.values()) is breaks
    d = str(tmp_path / "bound")
    os.makedirs(d)
    for i in range(1, len(ds)):
        sink.add(ds.load(i), *labels[i])
    _feed(ds, labels, d)
    with open(perform_stitch(d, d, "classic", threads=1)) as f:
        classic = f.read()
    assert sink.ready() is not breaks
    if not breaks:
        rows = list(sink.finish_iter([os.path.join(d, "pred_0.hdf")]))
        assert "".join(f">{c}\n{s}\n" for c, s in rows) == classic


@pytest.mark.parametrize("limit", [1, None], ids=["over-bound", "default-bound"])
def test_polish_over_the_bound_writes_the_store_stitch_fasta(images, tmp_path, monkeypatch,
                                                             limit):
    """polish with the streaming stitch, its bound at 1 byte (every
    multi-chunk region passes it) and at the default (never reached here):
    the FASTA equals the classic stitch's byte for byte, and the stream
    broke exactly when over the bound."""
    from helen_tpu_torch.infer.polish import polish
    from helen_tpu_torch.stitch import streaming

    broke = []
    mark = streaming.StreamingStitcher._mark_broken

    def spy(self):
        broke.append(self._unsealed_bytes)
        mark(self)

    monkeypatch.setattr(streaming.StreamingStitcher, "_mark_broken", spy)
    if limit is not None:
        monkeypatch.setattr(streaming.StreamingStitcher, "UNSEALED_BYTES_LIMIT", limit)
    model = golden("golden_model.pkl")
    run = lambda out, stream: polish(images, model, str(tmp_path / out),  # noqa: E731
                                     batch_size=4, num_workers=0, threads=2,
                                     stream_stitch=stream, device="cpu")
    with open(run("stream", True), "rb") as f:
        streamed = f.read()
    assert (len(broke) > 0 and broke[0] > 1) is (limit == 1)
    with open(run("classic", False), "rb") as f:
        assert f.read() == streamed
