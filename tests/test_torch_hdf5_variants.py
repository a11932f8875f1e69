"""The port on the HDF5 inputs helen_tpu reads through h5py: the golden
images written again chunked and compressed in the earliest format and in
the newest, and after a user block under h5py's lzf
(tests/torch_hdf5_variants/, by its make_variants.py), the golden images
after a user block of 512 or 4096 bytes or under lzf, and prediction stores
h5py writes under either ``libver``.

The committed variants hold the golden arrays; the port's
MarginPolishDataset loads every record of each as helen_tpu's does; ``polish
--device cpu`` of each writes tests/golden/golden.fa byte for byte; the
port stitches an oracle prediction store in either format to its truth.
"""
import glob
import hashlib
import os
import shutil
import sys

import h5py
import numpy as np
import pytest
import torch

from torch_port_fixtures import GOLDEN_DIR, golden

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANT_DIR = os.path.join(ROOT, "tests", "torch_hdf5_variants")
sys.path[:0] = [VARIANT_DIR, ROOT]  # make_variants, chip_smoke
import make_variants  # noqa: E402

VARIANTS = sorted(make_variants.VARIANTS)


def stage(tmp_path, name):
    d = tmp_path / "images"
    d.mkdir()
    shutil.copy(os.path.join(VARIANT_DIR, name), d / name)
    return str(d)


def test_variants_hold_the_golden_arrays():
    """What make_variants.py decodes from the golden gzip, array for array,
    through h5py and through the port's reader."""
    from helen_tpu_torch.io import hdf5

    want = make_variants.variant_records()
    for name in VARIANTS:
        path = os.path.join(VARIANT_DIR, name)
        with h5py.File(path, "r") as f, hdf5.File(path) as p:
            assert sorted(f["images"].keys()) == p["images"].keys() == sorted(want)
            for image, arrays in want.items():
                assert sorted(f["images"][image].keys()) == sorted(arrays)
                for key, value in arrays.items():
                    for got in (f["images"][image][key][()], p["images"][image][key][()]):
                        assert got.dtype == value.dtype and got.shape == value.shape
                        assert got.tolist() == value.tolist(), (name, image, key)
    with h5py.File(os.path.join(VARIANT_DIR, "images_latest.h5"), "r") as f:
        assert f.id.get_create_plist().get_version()[0] >= 2  # superblock 2 or 3
        assert f["images/gA_0_4819_0/image"].chunks == (128, 90)


@pytest.mark.parametrize("name", VARIANTS)
def test_port_loads_the_records_helen_tpu_loads(name):
    from helen_tpu.io.images import MarginPolishDataset as JaxDataset

    from helen_tpu_torch.io.images import MarginPolishDataset

    path = os.path.join(VARIANT_DIR, name)
    ours, theirs = MarginPolishDataset([path]), JaxDataset([path])
    assert ours.index == theirs.index and len(ours) == 11
    for i in range(len(ours)):
        a, b = ours.load(i), theirs.load(i)
        assert (a.contig, a.contig_start, a.contig_end, a.chunk_id) == (
            b.contig, b.contig_start, b.contig_end, b.chunk_id)
        assert ours.image_meta(i) == theirs.image_meta(i)
        for x, y in ((a.image, b.image), (a.position, b.position)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", VARIANTS)
def test_polish_of_each_variant_writes_the_golden_fasta(tmp_path, name):
    """Through chip_smoke.py's phase-13 helpers: the CLI's ``polish`` with
    the stage timer it made caught, and its labels against the recorded
    golden_labels.npz (0+0 flips)."""
    import chip_smoke

    from helen_tpu_torch.obs import StageTimer

    out = tmp_path / "out"
    timer = chip_smoke.cli_timed(
        ["polish", "-i", stage(tmp_path, name), "-m", golden("golden_model.pkl"), "-o",
         str(out), "--device", "cpu", "-t", "2"], "helen_tpu_torch.infer.polish")
    assert timer.stages["image_read"] > 0 and "call_consensus" in timer.stages
    assert sys.modules["helen_tpu_torch.infer.polish"].StageTimer is StageTimer
    preds = glob.glob(str(out / "predictions_*"))
    assert len(preds) == 1 and chip_smoke.golden_label_flips(preds[0]) == (0, 0, 11000)
    with open(out / "HELEN_prediction.fa", "rb") as a, \
            open(os.path.join(GOLDEN_DIR, "golden.fa"), "rb") as b:
        assert hashlib.sha256(a.read()).digest() == hashlib.sha256(b.read()).digest()


# h5py's keywords for the golden images written again: after a user block,
# or ``image`` and ``position`` chunked under lzf, with and without shuffle
FORMS = {"userblock512": ({"userblock_size": 512}, {}),
         "userblock4096": ({"userblock_size": 4096}, {}),
         "lzf": ({}, {"compression": "lzf"}),
         "shuffle_lzf": ({}, {"compression": "lzf", "shuffle": True})}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_polish_of_a_user_block_or_lzf_file_writes_the_golden_fasta(tmp_path, form):
    """The golden images as h5py writes them in ``form``: the port reads
    every dataset equal to h5py, and ``polish --device cpu`` of the file
    writes tests/golden/golden.fa byte for byte, as helen_tpu's consensus
    and stitch do on the same file."""
    from helen_tpu.infer.consensus import call_consensus
    from helen_tpu.infer.polish import perform_stitch

    from helen_tpu_torch.cli import main
    from helen_tpu_torch.io import hdf5
    from torch_port_fixtures import stage_golden_images

    file_kw, chunk_kw = FORMS[form]
    src = os.path.join(stage_golden_images(tmp_path / "golden"), "golden_images.h5")
    images = tmp_path / "images"
    images.mkdir()
    path = str(images / f"{form}.h5")
    with h5py.File(src, "r") as f, h5py.File(path, "w", **file_kw) as g:
        def copy(name, obj):
            if isinstance(obj, h5py.Group):
                g.require_group(name)
            elif chunk_kw and name.rpartition("/")[2] in make_variants.CHUNKS:
                shape = make_variants.CHUNKS[name.rpartition("/")[2]]
                g.create_dataset(name, data=obj[()], **chunk_kw,
                                 chunks=tuple(min(c, n) for c, n in zip(shape, obj.shape)))
            else:
                g.create_dataset(name, data=obj[()])
        f.visititems(copy)
    with h5py.File(path, "r") as f, hdf5.File(path) as p:
        if file_kw:
            assert f.userblock_size == file_kw["userblock_size"]
        names = []
        f.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        assert len(names) == 11 * 6
        for name in names:
            want, got = f[name][()], p[name][()]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.asarray(got).tolist() == np.asarray(want).tolist(), name
            if chunk_kw and name.endswith("/image"):
                assert f[name].compression == "lzf"
    with open(os.path.join(GOLDEN_DIR, "golden.fa"), "rb") as fh:
        want = fh.read()
    out = tmp_path / "out"
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(out), "--device", "cpu", "-t", "2"]) == 0
    with open(out / "HELEN_prediction.fa", "rb") as fh:
        assert fh.read() == want
    theirs = str(tmp_path / "helen_tpu")
    call_consensus(image_files=[path], model_path=golden("golden_model.pkl"),
                   output_dir=theirs, batch_size=4, num_workers=2)
    with open(perform_stitch(theirs, theirs, "polished", threads=1), "rb") as fh:
        assert fh.read() == want


def rewrite(src: str, dst: str, libver: str) -> None:
    """Copy every group and dataset of ``src`` into a new file written by
    h5py under ``libver``."""
    with h5py.File(src, "r") as f, h5py.File(dst, "w", libver=libver) as g:
        def copy(name, obj):
            if isinstance(obj, h5py.Group):
                g.require_group(name)
            else:
                g.create_dataset(name, data=obj[()])
        f.visititems(copy)


def test_polish_of_space_padded_contig_names_writes_helen_tpus_headers(tmp_path):
    """The golden images with every ``contig`` written as a space-padded
    string (pad type 2): the port reads the names helen_tpu reads through
    h5py, and ``polish --device cpu`` writes tests/golden/golden.fa byte
    for byte, its headers included."""
    from helen_tpu.io.images import MarginPolishDataset as JaxDataset

    from helen_tpu_torch.io.images import MarginPolishDataset
    from torch_port_fixtures import stage_golden_images

    src = os.path.join(stage_golden_images(tmp_path / "golden"), "golden_images.h5")
    images = tmp_path / "images"
    images.mkdir()
    dst = str(images / "spacepad.h5")
    with h5py.File(src, "r") as f, h5py.File(dst, "w") as g:
        def copy(name, obj):
            if isinstance(obj, h5py.Group):
                g.require_group(name)
            elif name.endswith("/contig"):
                t = h5py.h5t.C_S1.copy()
                t.set_size(obj.dtype.itemsize)
                t.set_strpad(h5py.h5t.STR_SPACEPAD)
                d = h5py.h5d.create(g.id, name.encode(), t,
                                    h5py.h5s.create_simple(obj.shape))
                d.write(h5py.h5s.ALL, h5py.h5s.ALL, obj[()])
            else:
                g.create_dataset(name, data=obj[()])
        f.visititems(copy)
    with h5py.File(dst, "r") as g:
        first = g["images"][sorted(g["images"])[0]]["contig"]
        assert first.id.get_type().get_strpad() == h5py.h5t.STR_SPACEPAD
    ours, theirs = MarginPolishDataset([dst]), JaxDataset([dst])
    assert [ours.image_meta(i) for i in range(len(ours))] == [
        theirs.image_meta(i) for i in range(len(theirs))]
    from helen_tpu_torch.cli import main

    out = tmp_path / "out"
    assert main(["polish", "-i", str(images), "-m", golden("golden_model.pkl"), "-o",
                 str(out), "--device", "cpu", "-t", "2"]) == 0
    with open(out / "HELEN_prediction.fa", "rb") as a, \
            open(os.path.join(GOLDEN_DIR, "golden.fa"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_port_stitches_a_store_h5py_wrote(tmp_path, libver):
    from helen_tpu.io import prediction_store as jax_store
    from helen_tpu.io.synthetic import random_sequence, write_prediction_file

    from helen_tpu_torch.io import prediction_store as store
    from helen_tpu_torch.stitch.engine import stitch_contig

    truth = {"ctg": random_sequence(9000, seed=11), "other": random_sequence(3000, seed=12)}
    original, path = str(tmp_path / "o.hdf"), str(tmp_path / "p.hdf")
    # 11 regions of "ctg": its group past 8 links, dense under "latest"
    write_prediction_file(original, truth, region_cols=300, overlap_cols=60)
    rewrite(original, path, libver)
    with h5py.File(path, "r") as f:
        assert len(f["predictions/ctg"]) == 11
    assert store.list_contigs([path]) == jax_store.list_contigs([path]) == sorted(truth)
    regions = store.list_region_keys([path], "ctg")
    assert regions == jax_store.list_region_keys([path], "ctg")
    for paths, key, _, _ in regions:
        got = list(store.read_region_chunks(paths, "ctg", key))
        want = list(jax_store.read_region_chunks(paths, "ctg", key))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    for contig, seq in truth.items():
        assert stitch_contig([path], contig, threads=1) == seq
