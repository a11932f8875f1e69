"""helen_tpu_torch.io.hdf5, the port's own HDF5 reader and writer, against
h5py (libhdf5) and against helen_tpu's writers.

The GPU hosts the port runs on need not have h5py, so the port reads image
files and writes and reads prediction stores through this module. Files it
writes must read back identically through libhdf5, and files that
helen_tpu and MarginPolish-style h5py writers produce must read back
identically through it.
"""
import os

import h5py
import numpy as np
import pytest

from torch_port_fixtures import stage_golden_images


def h5py_tree(path):
    """{dataset path: array} of a file, read by h5py."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def port_tree(path):
    from helen_tpu_torch.io import hdf5

    out = {}

    def walk(g, prefix):
        for k, v in g.items():
            if isinstance(v, hdf5.Group):
                walk(v, f"{prefix}{k}/")
            else:
                out[prefix + k] = v[()]

    with hdf5.File(path) as f:
        walk(f, "")
    return out


def assert_same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_reads_golden_images_like_h5py(tmp_path):
    path = os.path.join(stage_golden_images(tmp_path), "golden_images.h5")
    assert_same_tree(port_tree(path), h5py_tree(path))


def test_written_file_reads_back_through_libhdf5(tmp_path):
    """Nested groups, a group past one B-tree node (600 children), an empty
    group, and every dtype the port writes: scalar, empty and n-d."""
    from helen_tpu_torch.io import hdf5

    rng = np.random.default_rng(0)
    path = str(tmp_path / "w.h5")
    want = {}
    with hdf5.Writer(path) as w:
        for i in range(600):
            g = w.create_group(f"many/g{i}")
            want[f"many/g{i}/v"] = g["v"] = np.arange(i % 5, dtype=np.int64)
        w.create_group("empty")
        d = w.create_group("a/b/c")
        for name, arr in {
            "u8": rng.integers(0, 256, (7, 90), dtype=np.uint8),
            "u32": rng.integers(0, 2**32, (5, 3), dtype=np.uint32),
            "i64": np.int64(-12),
            "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
            "f64": np.float64(2.5),
            "s": np.array([b"contig_1"], dtype="S64"),
            "none": np.zeros((0, 3), dtype=np.uint8),
            "be": np.arange(4, dtype=">i4"),
        }.items():
            d[name] = arr
            want[f"a/b/c/{name}"] = arr
    assert_same_tree(h5py_tree(path), want)
    assert_same_tree(port_tree(path), want)
    with h5py.File(path, "r") as f:
        assert len(f["many"]) == 600 and len(f["empty"]) == 0


def test_synthetic_image_file_equals_helen_tpu(tmp_path):
    from helen_tpu.io.synthetic import random_sequence, write_image_file as jax_write

    from helen_tpu_torch.io.synthetic import write_image_file

    seqs = {"c1": random_sequence(4000, seed=1), "c2": random_sequence(2500, seed=2)}
    n = write_image_file(str(tmp_path / "p.h5"), seqs, region_cols=900, overlap_cols=80,
                         noise=0.1, seed=3)
    assert n == jax_write(str(tmp_path / "j.h5"), seqs, region_cols=900, overlap_cols=80,
                          noise=0.1, seed=3)
    assert_same_tree(h5py_tree(str(tmp_path / "p.h5")), h5py_tree(str(tmp_path / "j.h5")))


def test_reads_helen_tpu_prediction_store(tmp_path):
    """helen_tpu's store (h5py, compact datasets) reads back the same
    through the port's region reader."""
    from helen_tpu.io import prediction_store as jax_store
    from helen_tpu.io.synthetic import random_sequence, write_prediction_file

    from helen_tpu_torch.io import prediction_store as store

    path = str(tmp_path / "p.hdf")
    write_prediction_file(path, {"ctg": random_sequence(6000, seed=4)}, region_cols=700,
                          overlap_cols=60, qual=30)
    assert store.list_contigs([path]) == jax_store.list_contigs([path]) == ["ctg"]
    regions = store.list_region_keys([path], "ctg")
    assert regions == jax_store.list_region_keys([path], "ctg")
    for paths, key, _, _ in regions:
        got = list(store.read_region_chunks(paths, "ctg", key, with_quals=True))
        want = list(jax_store.read_region_chunks(paths, "ctg", key, with_quals=True))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_refuses_what_it_does_not_read(tmp_path):
    """Chunked+gzip and ``libver="latest"`` files read as h5py reads them
    (tests/test_torch_hdf5_formats.py holds the whole matrix), and so does
    an lzf one; a scale-offset filter and a file that is not HDF5 are
    refused, naming what they are."""
    from helen_tpu_torch.io import hdf5

    chunked = str(tmp_path / "c.h5")
    with h5py.File(chunked, "w") as f:
        f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="gzip")
    assert_same_tree(port_tree(chunked), h5py_tree(chunked))
    latest = str(tmp_path / "l.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f["x"] = np.arange(3)
    assert_same_tree(port_tree(latest), h5py_tree(latest))
    lzf = str(tmp_path / "lzf.h5")
    with h5py.File(lzf, "w") as f:
        f.create_dataset("x", data=np.arange(100), chunks=(10,), compression="lzf")
    assert_same_tree(port_tree(lzf), h5py_tree(lzf))
    scaleoffset = str(tmp_path / "so.h5")
    with h5py.File(scaleoffset, "w") as f:
        f.create_dataset("x", data=np.arange(100, dtype=np.int32), chunks=(10,),
                         scaleoffset=0)
    with pytest.raises(hdf5.UnsupportedHDF5, match="filter 6 .scaleoffset"):
        hdf5.File(scaleoffset)["x"][()]
    junk = tmp_path / "junk.h5"
    junk.write_bytes(b"not an hdf5 file at all")
    with pytest.raises(OSError, match="not an HDF5 file"):
        hdf5.File(str(junk))


def test_image_dataset_names_a_bad_file(tmp_path):
    from helen_tpu_torch.io.images import MarginPolishDataset

    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(OSError, match="bad.h5"):
        MarginPolishDataset([str(bad)])
