"""``--resume`` in the port: the prediction store's append mode and journal.

A complete store resumed into is neither grown nor rewritten; a run killed
(``os._exit`` from a stream sink) after a flush resumes without recomputing
the flushed records and stitches to the recorded golden FASTA byte for
byte; a resume across a change of pool size (2 writers, then 1) recomputes
nothing; the journal's recovery, the append to a complete store (into the
store's next file) and the cost of a flush, at the level of
``PredictionStore``. Stores are read back by h5py (libhdf5) as well as by
the port.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

import h5py
import numpy as np
import pytest
import torch

from torch_port_fixtures import golden, stage_golden_images, store_labels

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def consensus(images, out, **kw):
    from helen_tpu_torch.infer.consensus import call_consensus
    from helen_tpu_torch.obs import StageTimer

    timer = StageTimer()
    files = call_consensus(image_dir=str(images), model_path=golden("golden_model.pkl"),
                           output_dir=str(out), num_workers=2, device="cpu",
                           stage_timer=timer, **kw)
    return files, timer.counts.get("device_submit", 0)


def h5py_keys(path):
    with h5py.File(path, "r") as f:
        return {f"{r}-{c}" for g in f["predictions"].values() for r, rg in g.items()
                for c in rg if c not in ("contig_start", "contig_end")}


def stitched(pred_dir, out):
    from helen_tpu_torch.infer.polish import perform_stitch

    return sha256(perform_stitch(str(pred_dir), str(out), threads=1))


def test_resume_into_complete_store_adds_nothing_and_rewrites_nothing(tmp_path):
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "preds"
    (path,), computed = consensus(images, out, batch_size=4)
    assert computed == 3
    before = os.stat(path)
    data = open(path, "rb").read()
    files, computed = consensus(images, out, batch_size=4, resume=True)
    assert files == [path] and computed == 0
    after = os.stat(path)
    assert (after.st_mtime_ns, after.st_size) == (before.st_mtime_ns, before.st_size)
    assert open(path, "rb").read() == data
    assert sorted(os.listdir(out)) == ["helen_predictions_0.hdf"]
    assert stitched(out, tmp_path / "fa") == sha256(golden("golden.fa"))


KILLED_RUN = """
import os, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from helen_tpu_torch.infer.consensus import call_consensus


class Sink:
    # a stream sink receives each record the store accepts, as batches
    # drain: it ends the process after {after} of them
    n = 0

    def add(self, rec, bases, rles, quals):
        Sink.n += 1
        if Sink.n == {after}:
            os._exit(17)


if __name__ == "__main__":
    call_consensus(image_dir={images!r}, model_path={model!r}, output_dir={out!r},
                   batch_size=1, num_workers=1, device="cpu", num_writers={writers},
                   stream_sink_factory=lambda dataset, indices: Sink())
"""


def killed_run(tmp_path, images, out, writers=1, after=10):
    """call_consensus at -b 1 over the 11 golden images in a subprocess
    that exits with os._exit after ``after`` records drained. The store
    flushes at batch 0 and batch 10: the second covers the 9 records that
    drained before it. A pool's writers outlive their parent: each notices
    it is orphaned (within 5 s), publishes its shard and exits; this waits
    for that."""
    script = tmp_path / "killed.py"
    script.write_text(KILLED_RUN.format(root=ROOT, images=str(images),
                                        model=golden("golden_model.pkl"), out=str(out),
                                        writers=writers, after=after))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 17, proc.stderr[-3000:]
    deadline = time.monotonic() + 60
    while writers > 1 and any(n.endswith(".journal") for n in os.listdir(out)):
        assert time.monotonic() < deadline, os.listdir(out)
        time.sleep(0.5)


@pytest.mark.parametrize("writers", [1, 2], ids=["one_writer", "two_writers"])
def test_killed_run_resumes_without_recomputing_flushed_records(tmp_path, writers):
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "preds"
    killed_run(tmp_path, images, out, writers=writers)
    if writers == 1:
        # a killed single-writer run publishes nothing: its records are in
        # the partial file and its journal
        assert sorted(os.listdir(out)) == ["helen_predictions_0.hdf.journal",
                                           "helen_predictions_0.hdf.partial"]
    else:
        # the orphaned writers published what they were sent: the records
        # of the flushes
        shards = [str(out / n) for n in sorted(os.listdir(out))]
        assert sum(len(h5py_keys(p)) for p in shards) == 9
    files, computed = consensus(images, out, batch_size=1, resume=True,
                                num_writers=writers)
    assert computed == 2  # 11 images, 9 flushed before the kill
    assert sorted(os.listdir(out)) == sorted(os.path.basename(f) for f in files)
    assert stitched(out, tmp_path / "fa") == sha256(golden("golden.fa"))
    fresh = tmp_path / "fresh"
    consensus(images, fresh, batch_size=1, num_writers=writers)
    got = {k: v for f in files for k, v in store_labels(f).items()}
    want = {k: v for f in os.listdir(fresh) for k, v in store_labels(str(fresh / f)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
    for f in files:
        assert h5py_keys(f) == set(store_labels(f))


def test_resume_across_pool_size_change_recomputes_nothing(tmp_path):
    """Two writers, then a resume with one: every chunk is in the _w*
    shards, so the single-writer store receives none."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "preds"
    consensus(images, out, batch_size=4, num_writers=2)
    files, computed = consensus(images, out, batch_size=4, resume=True)
    assert computed == 0
    single = out / "helen_predictions_0.hdf"
    assert files == [str(single)]
    assert h5py_keys(str(single)) == set()
    assert stitched(out, tmp_path / "fa") == sha256(golden("golden.fa"))


def test_resume_publishes_a_killed_pool_shard_it_does_not_own(tmp_path):
    """A killed two-writer run, resumed with one writer: the two partial
    shards are published and their records skipped, not recomputed."""
    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "preds"
    killed_run(tmp_path, images, out, writers=2)
    files, computed = consensus(images, out, batch_size=1, resume=True)
    assert computed == 2
    assert sorted(n for n in os.listdir(out)) == [
        "helen_predictions_0.hdf", "helen_predictions_0_w0.hdf", "helen_predictions_0_w1.hdf"]
    assert stitched(out, tmp_path / "fa") == sha256(golden("golden.fa"))


def test_polish_resume_continues_the_newest_predictions_dir(tmp_path):
    from helen_tpu_torch.cli import main

    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(out), "--device", "cpu", "-t", "2"]) == 0
    preds = [d for d in os.listdir(out) if d.startswith("predictions_")]
    store = out / preds[0] / "helen_predictions_0.hdf"
    stamp = os.stat(store).st_mtime_ns
    os.unlink(out / "HELEN_prediction.fa")
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(out), "--device", "cpu", "-t", "2", "--resume"]) == 0
    assert [d for d in os.listdir(out) if d.startswith("predictions_")] == preds
    assert os.stat(store).st_mtime_ns == stamp
    assert sha256(out / "HELEN_prediction.fa") == sha256(golden("golden.fa"))


# --- the store itself ------------------------------------------------------

def record(i, rows=50):
    rng = np.random.default_rng(i)
    position = np.zeros((rows, 3), np.int64)
    position[:, 0] = np.arange(i * rows, (i + 1) * rows)
    return ("ctg", 100 * (i // 3), 100 * (i // 3) + 100, i % 3, position,
            rng.integers(0, 5, rows).astype(np.uint8), rng.integers(0, 11, rows).astype(np.uint8),
            rng.integers(0, 61, rows).astype(np.uint8))


def write(store, ids):
    for i in ids:
        assert store.write_prediction(*record(i))


def check(path, ids):
    """The file holds exactly records ``ids``, through h5py and the port."""
    from helen_tpu_torch.io import prediction_store as ps

    want = {f"ctg-{r[1]}-{r[2]}-{r[3]}": r for r in map(record, ids)}
    assert h5py_keys(path) == set(want)
    got = store_labels(path)
    assert set(got) == set(want)
    for k, r in want.items():
        np.testing.assert_array_equal(got[k][0], r[5])
    for paths, key, _, _ in ps.list_region_keys([path], "ctg"):
        for pos, bases, rles, quals in ps.read_region_chunks(paths, "ctg", key, with_quals=True):
            r = next(r for r in want.values() if (r[4][:, 0] == pos[:, 0]).all())
            np.testing.assert_array_equal(quals, r[7])


def crash(store):
    """What a kill leaves: the files as they are, nothing closed."""
    store.file._fh.close()
    store._journal.close()


def test_store_recovers_flushed_records_after_a_kill(tmp_path):
    from helen_tpu_torch.io.prediction_store import PredictionStore

    path = str(tmp_path / "p.hdf")
    store = PredictionStore(path, "w")
    write(store, range(7))
    store.flush()
    write(store, range(7, 10))  # written, not flushed: lost with the kill
    crash(store)
    assert not os.path.exists(path)
    store = PredictionStore(path, "a")
    assert all(store.has_chunk(*record(i)[:4]) for i in range(7))
    assert not any(store.has_chunk(*record(i)[:4]) for i in range(7, 10))
    write(store, range(7, 12))
    store.close()
    assert not os.path.exists(path + ".partial") and not os.path.exists(path + ".journal")
    check(path, range(12))


def test_store_journal_torn_last_line_is_ignored(tmp_path):
    from helen_tpu_torch.io.prediction_store import PredictionStore

    path = str(tmp_path / "p.hdf")
    store = PredictionStore(path, "w")
    write(store, range(4))
    store.flush()
    write(store, range(4, 6))
    store.flush()
    crash(store)
    with open(path + ".journal", "r+b") as f:  # a kill in the journal's last write
        f.truncate(os.path.getsize(path + ".journal") - 7)
    store = PredictionStore(path, "a")
    assert store.has_chunk(*record(4)[:4]) and not store.has_chunk(*record(5)[:4])
    store.close()
    check(path, range(5))


def test_append_keeps_the_complete_store_readable_until_it_closes(tmp_path):
    """Mode "a" on a complete store writes its new records to the store's
    next file, p.r1.hdf: the complete file is never written again, so it
    reads as it was through a kill, and the next resume recovers p.r1."""
    from helen_tpu_torch.io.prediction_store import PredictionStore, store_files

    path = str(tmp_path / "p.hdf")
    nxt = str(tmp_path / "p.r1.hdf")
    with PredictionStore(path, "w") as store:
        write(store, range(6))
    data = open(path, "rb").read()
    store = PredictionStore(path, "a")
    assert store.filename == nxt and not os.path.exists(nxt + ".partial")
    write(store, range(6, 9))
    store.flush()
    check(path, range(6))
    crash(store)
    check(path, range(6))
    assert store_files(path) == [path, nxt]
    store = PredictionStore(path, "a")  # recovers the appended records
    assert store.filename == nxt
    assert store.has_chunk(*record(0)[:4]) and store.has_chunk(*record(8)[:4])
    write(store, range(9, 10))
    store.close()
    assert open(path, "rb").read() == data
    check(path, range(6))
    check(nxt, range(6, 10))
    with PredictionStore(path, "a") as store:  # a third run with nothing new
        assert all(store.has_chunk(*record(i)[:4]) for i in range(10))
    assert sorted(os.listdir(tmp_path)) == ["p.hdf", "p.r1.hdf"]


def test_flush_writes_only_the_new_records(tmp_path):
    """A flush adds the payloads and one journal line per record (and per
    new region) since the last flush; no metadata is written before close."""
    from helen_tpu_torch.io.prediction_store import PredictionStore

    path = str(tmp_path / "p.hdf")
    store = PredictionStore(path, "w")
    sizes = []
    for lo in range(0, 30, 6):
        write(store, range(lo, lo + 6))
        store.flush()
        with open(path + ".journal") as f:
            lines = f.read().splitlines()
        assert all(json.loads(x) for x in lines)
        sizes.append((os.path.getsize(path + ".partial"), len(lines)))
    store.close()
    assert not os.path.exists(path + ".journal")  # removed at close
    payload = 6 * 50 * (12 + 3) + 2 * 16  # 6 records, 2 new regions of 2 int64
    assert [b - a for (a, _), (b, _) in zip(sizes, sizes[1:])] == [payload] * 4
    assert [b - a for (_, a), (_, b) in zip(sizes, sizes[1:])] == [6 + 2] * 4
    check(path, range(30))


def test_write_behind_syncs_payloads_between_flushes(tmp_path, monkeypatch):
    """Every WRITE_BEHIND_RECORDS records the write-behind thread syncs the
    payload file, before any flush; a sync that fails there is raised by
    the next flush, and the store stays resumable."""
    import threading

    from helen_tpu_torch.io import prediction_store as ps

    monkeypatch.setattr(ps, "WRITE_BEHIND_RECORDS", 3)
    synced = threading.Event()
    real_fsync = os.fsync
    fail = []

    def fsync(fd):
        if fail:
            raise OSError(5, "I/O error")
        real_fsync(fd)
        synced.set()

    monkeypatch.setattr(os, "fsync", fsync)
    path = str(tmp_path / "p.hdf")
    store = ps.PredictionStore(path, "w")
    write(store, range(2))
    assert not synced.wait(0.2)  # under WRITE_BEHIND_RECORDS: no sync yet
    write(store, range(2, 3))
    assert synced.wait(10)
    store.flush()
    fail.append(1)
    write(store, range(3, 6))  # the next write-behind sync fails
    store._behind.join(10)
    with pytest.raises(OSError):
        store.flush()
    fail.clear()
    store.abort()
    with ps.PredictionStore(path, "a") as store:  # the first flush's records
        assert all(store.has_chunk(*record(i)[:4]) for i in range(3))
    check(path, range(3))


def test_fresh_store_replaces_an_old_one_and_its_leftovers(tmp_path):
    from helen_tpu_torch.io.prediction_store import PredictionStore

    path = str(tmp_path / "p.hdf")
    with PredictionStore(path, "w") as store:
        write(store, range(3))
    store = PredictionStore(path, "a")
    write(store, range(3, 5))
    store.flush()
    crash(store)
    with PredictionStore(path, "w") as store:
        write(store, range(10, 12))
    assert sorted(os.listdir(tmp_path)) == ["p.hdf"]
    check(path, range(10, 12))


def test_store_left_by_an_exception_is_resumable_not_published(tmp_path):
    from helen_tpu_torch.io.prediction_store import PredictionStore

    path = str(tmp_path / "p.hdf")
    with pytest.raises(RuntimeError):
        with PredictionStore(path, "w") as store:
            write(store, range(3))
            raise RuntimeError("the device failed")
    assert not os.path.exists(path)
    with PredictionStore(path, "a") as store:
        assert all(store.has_chunk(*record(i)[:4]) for i in range(3))
    check(path, range(3))


def test_appends_to_a_store_helen_tpu_wrote(tmp_path):
    """A store h5py wrote (helen_tpu's, compact datasets) takes new records
    in mode "a", into its next file; h5py and helen_tpu's stitch read old
    and new."""
    from helen_tpu.io.prediction_store import list_region_keys, read_region_chunks
    from helen_tpu.io.synthetic import random_sequence, write_prediction_file

    from helen_tpu_torch.io.prediction_store import PredictionStore, store_files

    path = str(tmp_path / "p.hdf")
    write_prediction_file(path, {"ref": random_sequence(3000, seed=2)}, region_cols=700,
                          overlap_cols=60)
    old = h5py_keys(path)
    data = open(path, "rb").read()
    store = PredictionStore(path, "a")
    for k in old:
        contig, start, end, chunk = k.rsplit("-", 3)
        assert store.has_chunk(contig, int(start), int(end), int(chunk))
    write(store, range(4))
    store.close()
    files = store_files(path)
    assert files == [path, str(tmp_path / "p.r1.hdf")]
    assert open(path, "rb").read() == data
    assert h5py_keys(files[1]) == {f"ctg-{r[1]}-{r[2]}-{r[3]}" for r in map(record, range(4))}
    regions = list_region_keys(files, "ctg")
    got = [c for paths, key, _, _ in regions for c in read_region_chunks(paths, "ctg", key)]
    assert len(got) == 4
    assert sum(1 for paths, key, _, _ in list_region_keys(files, "ref")
               for _ in read_region_chunks(paths, "ref", key)) == len(old)
