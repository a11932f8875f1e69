"""``--writers`` in the port: io/writer_pool.py, helen_tpu's pool on the
port's own HDF5 writer.

Records route across shard files and stitch back to the sequence; dedupe
and resume are pool-wide; a writer's failure raises in the parent process;
orphaned writers publish their shards when the parent dies; ``polish --writers 3``
gives the recorded golden FASTA byte for byte and helen_tpu's stitch reads
the port's shards to the same FASTA; the workers import no torch.
"""
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import h5py
import numpy as np
import pytest
import torch

from torch_port_fixtures import golden, stage_golden_images

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def region_records(seq, region_cols=300, overlap_cols=40, chunk_cols=120):
    """(contig_start, contig_end, chunk_id, position, bases, rles) records
    covering ``seq`` with overlapping regions split into chunks."""
    from helen_tpu_torch.io.synthetic import partition_regions, rle_encode

    bases, rles = rle_encode(seq)
    records = []
    for region in partition_regions(bases, rles, "ctg", region_cols, overlap_cols):
        ncols = region.bases.shape[0]
        position = np.zeros((ncols, 3), dtype=np.int64)
        position[:, 0] = np.arange(region.col_start, region.col_start + ncols)
        for ci, cs in enumerate(range(0, ncols, chunk_cols)):
            ce = min(cs + chunk_cols, ncols)
            records.append((region.contig_start, region.contig_end, ci,
                            position[cs:ce], region.bases[cs:ce], region.runs[cs:ce]))
    return records


def test_pool_stitch_roundtrip(tmp_path):
    from helen_tpu_torch.io.prediction_store import list_contigs
    from helen_tpu_torch.io.synthetic import random_sequence
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool
    from helen_tpu_torch.stitch import stitch_contig

    seq = random_sequence(6000, seed=9)
    paths = [str(tmp_path / f"pred_0_w{k}.hdf") for k in range(3)]
    with PredictionWriterPool(paths, "w") as pool:
        for start, end, ci, pos, b, r in region_records(seq):
            assert pool.write_prediction("ctg", start, end, ci, pos, b, r)
            # a duplicate is dropped pool-wide regardless of routing
            assert not pool.write_prediction("ctg", start, end, ci, pos, b, r)
    assert sum(1 for p in paths if os.path.getsize(p) > 2000) >= 2
    assert sorted(os.listdir(tmp_path)) == sorted(os.path.basename(p) for p in paths)
    assert list_contigs(paths) == ["ctg"]
    assert stitch_contig(paths, "ctg", threads=1) == seq


def test_pool_resume_skips_existing(tmp_path):
    from helen_tpu_torch.io.prediction_store import store_files
    from helen_tpu_torch.io.synthetic import random_sequence
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool
    from helen_tpu_torch.stitch import stitch_contig

    seq = random_sequence(3000, seed=4)
    records = region_records(seq)
    paths = [str(tmp_path / f"pred_0_w{k}.hdf") for k in range(2)]
    half = len(records) // 2
    with PredictionWriterPool(paths, "w") as pool:
        for start, end, ci, pos, b, r in records[:half]:
            pool.write_prediction("ctg", start, end, ci, pos, b, r)
    with PredictionWriterPool(paths, "a") as pool:
        # startup collected every shard's chunks into the union set
        for start, end, ci, *_ in records[:half]:
            assert pool.has_chunk("ctg", start, end, ci)
        assert not pool.has_chunk("ctg", *records[half][:3])
        wrote = [pool.write_prediction("ctg", *r) for r in records]
    assert wrote == [False] * half + [True] * (len(records) - half)
    # each shard's new records went to its next file (pred_0_w<k>.r1.hdf)
    files = [f for p in paths for f in store_files(p)]
    assert len(files) == 4
    assert stitch_contig(files, "ctg", threads=1) == seq


def test_pool_rejects_slash_contig(tmp_path):
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool

    with PredictionWriterPool([str(tmp_path / "w0.hdf")], "w") as pool:
        with pytest.raises(ValueError, match="'/'"):
            pool.write_prediction("chr/1", 0, 10, 0, np.zeros((2, 3)), np.zeros(2),
                                  np.zeros(2))


def test_pool_startup_error_propagates(tmp_path):
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool

    with pytest.raises(RuntimeError, match="failed to start"):
        PredictionWriterPool([str(tmp_path / "no" / "such" / "dir" / "w0.hdf")], "w")


def test_a_writer_that_fails_raises_in_the_parent(tmp_path):
    """A record the writer process cannot store (a position array that is
    not (L, 3)) fails in the worker; the parent's flush raises it."""
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool

    pool = PredictionWriterPool([str(tmp_path / "w0.hdf")], "w")
    pool.write_prediction("c", 0, 10, 0, np.zeros((2, 3)), np.zeros(2), np.zeros(2))
    pool.write_prediction("c", 0, 10, 1, np.zeros((2, 3)), object(), np.zeros(2))
    with pytest.raises(RuntimeError, match="prediction writer failed"):
        pool.flush()
    assert all(not p.is_alive() for p in pool._procs)


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_polish_writers_3_gives_golden_and_helen_tpu_stitches_the_shards(tmp_path):
    from helen_tpu.infer.polish import perform_stitch as jax_stitch

    from helen_tpu_torch.cli import main

    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(out), "--device", "cpu", "-t", "2", "--writers", "3", "-b", "4"]) == 0
    want = sha256(golden("golden.fa"))
    assert sha256(out / "HELEN_prediction.fa") == want
    preds = [d for d in os.listdir(out) if d.startswith("predictions_")]
    shards = sorted(os.listdir(out / preds[0]))
    assert shards == [f"helen_predictions_0_w{k}.hdf" for k in range(3)]
    assert sha256(jax_stitch(str(out / preds[0]), str(tmp_path / "ref"), threads=1)) == want


ORPHAN_PARENT = """
import json, sys, time
sys.path.insert(0, {root!r})
import numpy as np


def main():
    from helen_tpu_torch.io.writer_pool import PredictionWriterPool

    pool = PredictionWriterPool([{w0!r}, {w1!r}], "w")
    pos = np.zeros((10, 3), np.int64)
    pool.write_prediction("c", 0, 100, 0, pos, np.zeros(10, np.uint8), np.zeros(10, np.uint8))
    pool.flush()
    with open({pids!r}, "w") as f:
        json.dump([p.pid for p in pool._procs], f)
    print("READY", flush=True)
    time.sleep(120)  # parked: the test kills us here


if __name__ == "__main__":
    main()
"""


def test_orphaned_writers_publish_their_shards_and_exit(tmp_path):
    """SIGKILL the parent: its writers notice they are orphaned, publish
    their shards (readable, holding what they were sent) and exit."""
    script = tmp_path / "parent.py"
    w0, w1 = str(tmp_path / "w0.hdf"), str(tmp_path / "w1.hdf")
    script.write_text(ORPHAN_PARENT.format(root=ROOT, w0=w0, w1=w1,
                                           pids=str(tmp_path / "pids.json")))
    p = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "READY"
    pids = json.load(open(tmp_path / "pids.json"))
    os.kill(p.pid, signal.SIGKILL)
    p.wait()

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        return True

    deadline = time.monotonic() + 60
    while any(alive(pid) for pid in pids):
        assert time.monotonic() < deadline, "orphaned writers still running"
        time.sleep(0.5)
    n = 0
    for path in (w0, w1):
        with h5py.File(path, "r") as f:
            n += sum(len(rg) - 2 for g in f["predictions"].values() for rg in g.values())
    assert n == 1


def test_writer_modules_import_no_torch():
    """The spawned writers import io.writer_pool and io.prediction_store:
    with torch made unimportable, both import and a one-writer pool writes
    and closes a shard."""
    code = (
        "import sys, tempfile, os\n"
        "sys.modules['torch'] = None\n"
        "import numpy as np\n"
        "from helen_tpu_torch.io.writer_pool import PredictionWriterPool\n"
        "d = tempfile.mkdtemp()\n"
        "if __name__ == '__main__':\n"
        "    with PredictionWriterPool([os.path.join(d, 'w0.hdf')], 'w') as pool:\n"
        "        pool.write_prediction('c', 0, 9, 0, np.zeros((3, 3)), np.zeros(3), np.zeros(3))\n"
        "    assert 'torch' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
