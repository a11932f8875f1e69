"""``--pack`` in the port: io/packed.py against helen_tpu's io/packed.py.

The cache holds the images MarginPolishDataset reads; a packed consensus
gives the unpacked labels; the write-through cache equals the upfront one
array for array; the tee's incomplete, abandon, subset and failure cases;
helen_tpu reads the port's cache to the same arrays, and a cache helen_tpu
wrote (h5py, chunked) is rebuilt by the port, not an error; ``train
--pack`` trains to the same parameters as without it.
"""
import glob
import os

import numpy as np
import pytest
import torch

from torch_port_fixtures import golden, stage_golden_images, store_labels

torch.set_num_threads(2)

ARRAYS = ("images", "positions", "contig_ids", "contig_start", "contig_end", "chunk_id",
          "source_mtimes", "image_shape", "with_labels")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    d = tmp_path_factory.mktemp("pack")
    paths = []
    for i in range(2):
        p = str(d / f"img_{i}.h5")
        write_image_file(p, {f"c{i}": random_sequence(5000, seed=i)},
                         region_cols=800, overlap_cols=80, noise=0.1)
        paths.append(p)
    return paths


def port_arrays(path):
    from helen_tpu_torch.io import hdf5

    with hdf5.File(path) as f:
        return {k: f["packed"][k][()] for k in f["packed"].keys()}


def test_pack_roundtrip(image_files, tmp_path):
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.io.packed import PackedDataset, pack_images

    cache = str(tmp_path / "cache.h5")
    n = pack_images(image_files, cache, with_labels=True)
    ref = MarginPolishDataset(image_files, with_labels=True)
    assert n == len(ref)
    packed = PackedDataset(cache, with_labels=True)
    order = np.array([n - 1, 0, n // 2, 0])  # any order, repeats allowed
    for idx in (np.arange(n), order):
        batch = packed.read_batch(idx)
        for j, i in enumerate(idx):
            a, b = ref.load(int(i)), batch.records[j]
            assert (a.contig, a.contig_start, a.contig_end, a.chunk_id) == (
                b.contig, b.contig_start, b.contig_end, b.chunk_id)
            np.testing.assert_array_equal(a.image, batch.images[j])
            np.testing.assert_array_equal(a.position, b.position)
            np.testing.assert_array_equal(a.label_base, b.label_base)
            np.testing.assert_array_equal(a.label_rle, batch.labels_rle[j])
    assert packed.image_meta(n - 1) == (ref.load(n - 1).contig, *[
        getattr(ref.load(n - 1), k) for k in ("contig_start", "contig_end", "chunk_id")])


def test_cache_freshness(image_files, tmp_path):
    from helen_tpu_torch.io.packed import cache_is_fresh, pack_images

    cache = str(tmp_path / "cache.h5")
    assert not cache_is_fresh(cache, image_files)
    pack_images(image_files, cache)
    assert cache_is_fresh(cache, image_files)
    assert not cache_is_fresh(cache, image_files, with_labels=True)
    assert not cache_is_fresh(cache, image_files[:1])
    assert not cache_is_fresh(cache, image_files, indices=[0, 1])
    st = os.stat(image_files[0])
    os.utime(image_files[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        assert not cache_is_fresh(cache, image_files)  # a touched source
    finally:
        os.utime(image_files[0], ns=(st.st_atime_ns, st.st_mtime_ns))
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_packed_iterator_pads(image_files, tmp_path):
    from helen_tpu_torch.io.packed import PackedDataset, pack_images, packed_batch_iterator

    cache = str(tmp_path / "cache.h5")
    n = pack_images(image_files, cache)
    ds = PackedDataset(cache)
    batches = list(packed_batch_iterator(ds, 4))
    assert sum(b.valid for b in batches) == n
    assert all(b.images.shape[0] == 4 for b in batches)
    ragged = list(packed_batch_iterator(ds, 4, pad_final=False))
    assert ragged[-1].images.shape[0] == ragged[-1].valid == n - 4 * (len(ragged) - 1)


def run_consensus(image_files, out, **kw):
    from helen_tpu_torch.infer.consensus import call_consensus
    from helen_tpu_torch.obs import StageTimer

    timer = StageTimer()
    files = call_consensus(image_files=image_files, model_path=golden("golden_model.pkl"),
                           output_dir=str(out), batch_size=4, num_workers=2, device="cpu",
                           stage_timer=timer, **kw)
    return files, timer


def test_consensus_pack_matches_unpacked_and_cache_is_written_through(image_files, tmp_path):
    """The first packed run tees its images into the cache (no upfront
    pack); the second slab-reads it; both give the unpacked labels, and the
    tee's cache equals pack_images' array for array."""
    from helen_tpu_torch.io.packed import cache_is_fresh, pack_images

    (plain,), _ = run_consensus(image_files, tmp_path / "plain")
    want = store_labels(plain)
    cache_dir = tmp_path / "cache"
    for run, stage in (("first", True), ("second", False)):
        (f,), timer = run_consensus(image_files, tmp_path / run, pack=True,
                                    cache_dir=str(cache_dir))
        assert ("pack_tee" in timer.stages) == stage
        got = store_labels(f)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            np.testing.assert_array_equal(got[k][1], want[k][1])
    cache = str(cache_dir / "images_cache.h5")
    assert cache_is_fresh(cache, image_files)
    upfront = str(tmp_path / "upfront.h5")
    pack_images(image_files, upfront)
    a, b = port_arrays(cache), port_arrays(upfront)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_consensus_pack_of_no_images_raises_over_a_stale_cache(image_files, tmp_path):
    """Image files that hold no images, beside a stale cache of other files
    or none: the run raises "no images found" and never reads the cache."""
    from helen_tpu_torch.io.packed import pack_images
    from helen_tpu_torch.io.synthetic import write_image_file

    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    cache = cache_dir / "images_cache.h5"
    pack_images(image_files, str(cache))
    stamp = os.stat(cache).st_mtime_ns
    empty = str(tmp_path / "empty.h5")
    write_image_file(empty, {})
    with pytest.raises(ValueError, match="no images found"):
        run_consensus([empty], tmp_path / "stale", pack=True, cache_dir=str(cache_dir))
    assert os.stat(cache).st_mtime_ns == stamp
    os.unlink(cache)
    with pytest.raises(ValueError, match="no images found"):
        run_consensus([empty], tmp_path / "none", pack=True, cache_dir=str(cache_dir))
    assert not glob.glob(str(tmp_path / "*" / "*.hdf"))


def test_pack_tee_incomplete_discards(image_files, tmp_path):
    from helen_tpu_torch.config import IMAGE
    from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
    from helen_tpu_torch.io.packed import PackTee

    ds = MarginPolishDataset(image_files)
    assert len(ds) >= 2
    cache = str(tmp_path / "cache.h5")
    tee = PackTee(cache, len(ds), IMAGE, image_files)
    tee.add_batch(next(iter(batched_image_iterator(ds, 1, num_workers=1))))
    assert tee.finalize() is False
    assert not os.path.exists(cache)
    assert not os.path.exists(tee.tmp)


def test_pack_tee_abandon(image_files, tmp_path):
    from helen_tpu_torch.config import IMAGE
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.io.packed import PackTee

    ds = MarginPolishDataset(image_files)
    cache = str(tmp_path / "cache.h5")
    tee = PackTee(cache, len(ds), IMAGE, image_files)
    tee.abandon()
    assert not os.path.exists(cache)
    assert not os.path.exists(tee.tmp)
    tee.abandon()  # idempotent


def test_pack_tee_subset_indices(image_files, tmp_path):
    from helen_tpu_torch.config import IMAGE
    from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
    from helen_tpu_torch.io.packed import PackTee, cache_is_fresh, pack_images

    ds = MarginPolishDataset(image_files)
    subset = list(range(0, len(ds), 2))
    cache = str(tmp_path / "cache.h5")
    tee = PackTee(cache, len(subset), IMAGE, image_files, indices=subset)
    for batch in batched_image_iterator(ds, 2, num_workers=1, indices=subset):
        tee.add_batch(batch)
    assert tee.finalize() is True
    assert cache_is_fresh(cache, image_files, indices=subset)
    assert not cache_is_fresh(cache, image_files)  # a full-set consumer: stale
    upfront = str(tmp_path / "upfront.h5")
    pack_images(image_files, upfront, indices=subset)
    a, b = port_arrays(cache), port_arrays(upfront)
    for name in ("images", "positions", "contig_ids", "chunk_id", "source_indices"):
        np.testing.assert_array_equal(a[name], b[name])


def test_pack_tee_write_error_raises_and_removes_the_tmp_file(image_files, tmp_path):
    """A failed tee write is not swallowed: the feeder gets the error and
    the partial cache is gone."""
    from helen_tpu_torch.config import IMAGE
    from helen_tpu_torch.io.images import MarginPolishDataset, batched_image_iterator
    from helen_tpu_torch.io.packed import PackTee

    ds = MarginPolishDataset(image_files)
    cache = str(tmp_path / "cache.h5")
    tee = PackTee(cache, 1, IMAGE, image_files)  # promised one image, sent more
    tee.add_batch(next(iter(batched_image_iterator(ds, 2, num_workers=1))))
    with pytest.raises(ValueError, match="expected 1"):
        tee.finalize()
    assert not os.path.exists(cache) and not os.path.exists(tee.tmp)


def test_consensus_raises_when_the_tee_fails(image_files, tmp_path, monkeypatch):
    from helen_tpu_torch.io import packed

    def broken(self):
        while self._q.get() is not None:
            self.error = OSError("no space left on device")

    monkeypatch.setattr(packed.PackTee, "_writer", broken)
    with pytest.raises(OSError, match="no space"):
        run_consensus(image_files, tmp_path / "out", pack=True)
    assert not [p for p in os.listdir(tmp_path / "out") if "images_cache" in p]


def test_helen_tpu_reads_the_port_cache(image_files, tmp_path):
    from helen_tpu.io.packed import PackedDataset as JaxPacked
    from helen_tpu.io.packed import cache_is_fresh as jax_fresh

    from helen_tpu_torch.io.packed import PackedDataset, pack_images

    cache = str(tmp_path / "cache.h5")
    n = pack_images(image_files, cache, with_labels=True)
    assert jax_fresh(cache, image_files, with_labels=True)
    ours, theirs = PackedDataset(cache, with_labels=True), JaxPacked(cache, with_labels=True)
    assert ours.contigs == theirs.contigs
    idx = np.arange(n)
    a, b = ours.read_batch(idx), theirs.read_batch(idx)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels_base, b.labels_base)
    np.testing.assert_array_equal(a.labels_rle, b.labels_rle)
    for x, y in zip(a.records, b.records):
        assert (x.contig, x.contig_start, x.contig_end, x.chunk_id) == (
            y.contig, y.contig_start, y.contig_end, y.chunk_id)
        np.testing.assert_array_equal(x.position, y.position)


def test_a_cache_helen_tpu_wrote_is_rebuilt(image_files, tmp_path):
    from helen_tpu.io.packed import pack_images as jax_pack

    from helen_tpu_torch.io.packed import cache_is_fresh

    (plain,), _ = run_consensus(image_files, tmp_path / "plain")
    cache_dir = tmp_path / "cache"
    cache_dir.mkdir()
    cache = str(cache_dir / "images_cache.h5")
    jax_pack(image_files, cache)
    assert not cache_is_fresh(cache, image_files)
    (f,), timer = run_consensus(image_files, tmp_path / "out", pack=True,
                                cache_dir=str(cache_dir))
    assert "pack_tee" in timer.stages
    assert cache_is_fresh(cache, image_files)
    got, want = store_labels(f), store_labels(plain)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])


def test_polish_pack_reuses_its_cache_and_polishes_golden(tmp_path):
    import hashlib

    from helen_tpu_torch.cli import main

    images = stage_golden_images(tmp_path / "images")
    out = tmp_path / "out"
    stamps = []
    for _ in range(2):
        assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                     str(out), "--device", "cpu", "-t", "2", "--pack"]) == 0
        stamps.append(os.stat(out / "images_cache.h5").st_mtime_ns)
        with open(out / "HELEN_prediction.fa", "rb") as a, open(golden("golden.fa"), "rb") as b:
            assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest()
    assert stamps[0] == stamps[1]
    assert len(glob.glob(str(out / "predictions_*"))) == 2


def test_train_pack_matches_unpacked(tmp_path):
    """One epoch of ``train --pack`` and of ``train`` (a fresh H=16 model,
    the same seed): the same parameters, bit for bit; the cache is reused
    by a second packed run."""
    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io.checkpoint import load_checkpoint
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    for name, bp in (("tr", 6000), ("te", 2500)):
        os.makedirs(tmp_path / name)
        write_image_file(str(tmp_path / name / "i.h5"), {name: random_sequence(bp, seed=bp)},
                         region_cols=1000, overlap_cols=0, noise=0.05)
    params = {}
    for run in ("plain", "pack", "pack_again"):
        out = tmp_path / run
        argv = ["train", "--train_image_dir", str(tmp_path / "tr"), "--test_image_dir",
                str(tmp_path / "te"), "-b", "4", "-e", "1", "-w", "2", "-o", str(out),
                "--device", "cpu", "--hidden_size", "16"]
        if run == "pack_again":
            out = tmp_path / "pack"
            argv[argv.index("-o") + 1] = str(out)
        assert main(argv + (["--pack"] if run != "plain" else [])) == 0
        ckpt = sorted(glob.glob(str(out / "trained_models_*" / "models" /
                                    "HELEN_epoch_1_checkpoint.npz")))[-1]
        params[run] = load_checkpoint(ckpt)[0]
        if run == "pack":
            stamp = os.stat(out / "train_images_cache.h5").st_mtime_ns
    assert os.stat(tmp_path / "pack" / "train_images_cache.h5").st_mtime_ns == stamp

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)])

    want = dict(leaves(params["plain"]))
    for run in ("pack", "pack_again"):
        got = dict(leaves(params[run]))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{run} {k}")
