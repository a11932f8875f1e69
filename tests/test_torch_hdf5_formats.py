"""helen_tpu_torch.io.hdf5's reader against h5py on the HDF5 forms libhdf5
writes: the earliest and the newest (``libver="latest"``) format, every
chunk index (version-1 B-tree; single chunk, implicit, fixed array paged
and not, extensible array, version-2 B-tree), the deflate, shuffle,
fletcher32 and lzf filters, variable-length strings, fill values, groups in
symbol-table, compact and dense storage, and a user block before the
superblock. Each case holds ``dset[()]``,
``dset[a:b]`` and ``dset[index_array]`` to what h5py reads; corrupt data
and checksums raise ``OSError`` naming the file; what the reader does not
read raises ``UnsupportedHDF5`` naming it.
"""
import struct
import threading

import h5py
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from helen_tpu_torch.io import _hdf5_chunks, _hdf5_filters, hdf5
from helen_tpu_torch.io._hdf5_v2 import lookup3

LIBVERS = ("earliest", "latest")
# (shape of a 2-D dataset, its chunks; a 1-D one takes the first axis) and
# the chunk index each gives under libver="latest"
CHUNKINGS = {
    "edge": ((300, 7), (128, 4), 3),       # edge chunks on both axes, fixed array
    "single": ((300, 7), (300, 7), 1),     # one chunk, the single-chunk index
    "paged": ((1100, 3), (1, 3), 3),       # 1,100 chunks: a paged fixed array
}
FILTERS = {
    "none": {},
    "gzip": dict(compression="gzip"),
    "shuffle_gzip": dict(compression="gzip", shuffle=True),
    "fletcher32": dict(fletcher32=True),
    "lzf": dict(compression="lzf"),
    "shuffle_lzf": dict(compression="lzf", shuffle=True),
}
DTYPES = ("u8", "i64", ">i4", "f32", "S", "vlen")


def make_data(dtype: str, shape, rng):
    rows = shape[0]
    if dtype == "u8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "i64":
        return rng.integers(-2**40, 2**40, shape, dtype=np.int64)
    if dtype == ">i4":
        return rng.integers(-2**30, 2**30, shape).astype(">i4")
    if dtype == "f32":
        return rng.standard_normal(shape).astype(np.float32)
    if dtype == "S":
        return np.array([b"ctg_%d" % i for i in range(rows)], dtype="S12")
    return np.array([("contig_%d_" % i) * (i % 5) for i in range(rows)], dtype=object)


def create(f, name, data, **kw):
    if data.dtype == object:
        return f.create_dataset(name, data=data, dtype=h5py.string_dtype(), **kw)
    return f.create_dataset(name, data=data, **kw)


def as_list(a):
    return [bytes(x) if isinstance(x, (bytes, np.bytes_)) else x
            for x in np.asarray(a, dtype=object).reshape(-1)]


def assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == object:
        assert got.dtype == object, what
        assert as_list(got) == as_list(want), what
    else:
        assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_reads_like_h5py(path, name, rng):
    """``dset[()]``, row slices (across chunk edges, empty, to the end) and
    index arrays (sorted for h5py; unsorted, repeated and negative against
    the whole array) read the same through both."""
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        a, b = f[name], g[name]
        assert b.shape == a.shape and b.dtype == a.dtype
        whole = a[()]
        assert_same(b[()], whole, "whole")
        n = a.shape[0]
        for lo, hi in ((0, n), (1, n - 1), (n // 3, n // 3 + 130), (5, 5), (n - 2, n + 9)):
            assert_same(b[lo:hi], a[lo:hi], f"[{lo}:{hi}]")
        rows = np.unique(rng.integers(0, n, 40))
        assert_same(b[rows], a[rows], "sorted rows")
        shuffled = rng.integers(-n, n, 60)
        assert_same(b[shuffled], whole[shuffled], "unsorted rows")
        return b


def index_of(path, name):
    with hdf5.File(path) as g:
        return g[name]._layout[1].index


CASES = [(lv, ck, fl, dt) for lv in LIBVERS for ck in CHUNKINGS for fl in FILTERS
         for dt in DTYPES if not (dt == "vlen" and fl == "fletcher32")]  # libhdf5 refuses it


@pytest.mark.parametrize("libver,chunking,filters,dtype", CASES)
def test_chunked_dataset_reads_like_h5py(tmp_path, libver, chunking, filters, dtype):
    shape, chunks, latest_index = CHUNKINGS[chunking]
    rng = np.random.default_rng(len(CASES))
    data = make_data(dtype, shape if dtype not in ("S", "vlen") else shape[:1], rng)
    path = str(tmp_path / "d.h5")
    with h5py.File(path, "w", libver=libver) as f:
        create(f, "d", data, chunks=chunks[:data.ndim], **FILTERS[filters])
    assert_reads_like_h5py(path, "d", rng)
    assert index_of(path, "d") == (latest_index if libver == "latest" else 0)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("filters", sorted(FILTERS))
@pytest.mark.parametrize("maxshape", ["one_axis", "two_axes"])
def test_unlimited_dataset_reads_like_h5py(tmp_path, libver, filters, maxshape):
    """``maxshape=None`` on one axis (an extensible array past its index
    block, into super blocks: 350 chunks) and on two (a version-2 B-tree of
    525 chunks)."""
    rng = np.random.default_rng(7)
    data = rng.integers(-2**40, 2**40, (700, 9), dtype=np.int64)
    top, chunks, index = (((None, 9), (2, 9), 4) if maxshape == "one_axis"
                          else ((None, None), (4, 3), 5))
    path = str(tmp_path / "u.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("u", data=data, chunks=chunks, maxshape=top, **FILTERS[filters])
        # the unlimited axis need not be the first
        f.create_dataset("t", data=data.T.copy(), chunks=chunks[::-1], maxshape=top[::-1],
                         **FILTERS[filters])
    assert_reads_like_h5py(path, "u", rng)
    assert_reads_like_h5py(path, "t", rng)
    assert index_of(path, "u") == (index if libver == "latest" else 0)


@pytest.mark.parametrize("libver", LIBVERS)
def test_implicit_index_reads_like_h5py(tmp_path, libver):
    """Early allocation, no filter, fixed shape: the implicit index under
    ``libver="latest"`` (chunks at computed addresses)."""
    path = str(tmp_path / "i.h5")
    with h5py.File(path, "w", libver=libver) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((7, 3))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"i", h5py.h5t.NATIVE_INT64, h5py.h5s.create_simple((50, 3)),
                        dcpl=dcpl)
        f["i"][:40] = np.arange(120).reshape(40, 3)
    assert_reads_like_h5py(path, "i", np.random.default_rng(3))
    assert index_of(path, "i") == (2 if libver == "latest" else 0)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("maxshape", ["fixed", "one_axis", "two_axes"])
def test_chunks_never_written_read_as_the_fill_value(tmp_path, libver, maxshape):
    top = {"fixed": None, "one_axis": (None, 4), "two_axes": (None, None)}[maxshape]
    path = str(tmp_path / "h.h5")
    with h5py.File(path, "w", libver=libver) as f:
        x = f.create_dataset("x", shape=(500, 4), dtype=np.int32, chunks=(10, 4),
                             fillvalue=-7, compression="gzip", maxshape=top)
        x[100:130] = 5
        y = f.create_dataset("y", shape=(3000,), dtype=np.float32, chunks=(1,),
                             fillvalue=2.5, maxshape=top and top[:1])
        y[2500:2600] = 9
        f.create_dataset("z", shape=(40, 2), dtype=np.int16, chunks=(8, 2), maxshape=top)
    rng = np.random.default_rng(5)
    for name in "xyz":
        assert_reads_like_h5py(path, name, rng)
    with hdf5.File(path) as g:
        assert (g["x"][()][:100] == -7).all() and (g["y"][:2500] == 2.5).all()
        assert (g["z"][()] == 0).all()


@pytest.mark.parametrize("libver", LIBVERS)
def test_scalars_empty_and_contiguous_datasets(tmp_path, libver):
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("vs", data="helen", dtype=h5py.string_dtype())
        f.create_dataset("vs1", data=["gA"], dtype=h5py.string_dtype())
        f["i"] = np.int64(-5)
        f["e"] = np.zeros((0, 3), np.uint8)
        f["c"] = np.arange(12, dtype=">f8").reshape(4, 3)
        f.create_dataset("k", data=np.arange(6, dtype=np.int16), chunks=(6,),
                         compression="gzip", compression_opts=9)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g["vs"][()] == f["vs"][()] == b"helen"
        assert type(g["vs"][()]) is bytes
        got = g["vs1"][()]
        assert got.dtype == object and list(got) == [b"gA"]
        for name in ("i", "e", "c", "k"):
            assert_same(g[name][()], f[name][()], name)


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("links", [0, 8, 9, 2000])
def test_groups_list_the_links_h5py_lists(tmp_path, libver, links):
    """0 and 8 links stay in the header under ``libver="latest"``; 9 and
    2,000 go to dense storage. The names and the objects they lead to."""
    path = str(tmp_path / "g.h5")
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("g")
        for i in range(links):
            if i % 3:
                g.create_dataset(f"d{i}", data=np.arange(i % 11, dtype=np.int32))
            else:
                g.create_group(f"sub{i}").create_dataset("v", data=np.int64(i))
    with h5py.File(path, "r") as f, hdf5.File(path) as p:
        assert p["g"].keys() == sorted(f["g"].keys())
        assert len(p["g"].keys()) == links
        for name, obj in p["g"].items():
            if isinstance(obj, hdf5.Group):
                assert isinstance(f["g"][name], h5py.Group)
                assert_same(obj["v"][()], f["g"][name]["v"][()], name)
            else:
                assert_same(obj[()], f["g"][name][()], name)
        assert ("g/d1" in p) == (links > 1) and "g/missing" not in p


def test_dense_group_past_the_root_direct_blocks(tmp_path):
    """12,000 long link names fill the fractal heap's direct rows, so the
    root indirect block holds indirect blocks too."""
    path = str(tmp_path / "many.h5")
    with h5py.File(path, "w", libver="latest") as f:
        ds = f.create_dataset("x", data=np.arange(3))
        g = f.create_group("many")
        for i in range(12000):
            g[f"a_rather_long_link_name_to_fill_the_heap_{i:06d}"] = ds
    with h5py.File(path, "r") as f, hdf5.File(path) as p:
        names = p["many"].keys()
        assert names == sorted(f["many"].keys()) and len(names) == 12000
        for name in names[::1499]:
            np.testing.assert_array_equal(p["many"][name][()], np.arange(3))


def _flip(path, offset):
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("libver", LIBVERS)
def test_a_corrupt_fletcher32_chunk_raises_naming_the_file(tmp_path, libver):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=np.arange(4000, dtype=np.int64), chunks=(1000,),
                         fletcher32=True)
        addr = f["x"].id.get_chunk_info(2).byte_offset
    _flip(path, addr + 17)
    with h5py.File(path, "r") as f, pytest.raises(OSError):
        f["x"][()]  # libhdf5 refuses it too
    with hdf5.File(path) as g:
        np.testing.assert_array_equal(g["x"][:2000], np.arange(2000))  # other chunks read
        with pytest.raises(OSError, match=r"f\.h5.*x.*fletcher32"):
            g["x"][()]


def test_a_corrupt_object_header_raises_naming_the_file(tmp_path):
    path = str(tmp_path / "o.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(10)
    with hdf5.File(path) as g:
        addr = g._table()["x"]
    with open(path, "rb") as fh:
        assert fh.read()[addr:addr + 4] == b"OHDR"
    _flip(path, addr + 8)
    with pytest.raises(OSError, match=r"o\.h5.*object header.*checksum"):
        hdf5.File(path)["x"]
    # the superblock's own checksum
    _flip(path, 40)
    with pytest.raises(OSError, match=r"o\.h5.*superblock.*checksum"):
        hdf5.File(path)


@pytest.mark.parametrize("libver", LIBVERS)
def test_refuses_other_filters_and_links_naming_them(tmp_path, libver):
    path = str(tmp_path / "r.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("lzf", data=np.arange(100), chunks=(10,), compression="lzf")
        f.create_dataset("so", data=np.arange(100, dtype=np.int32), chunks=(10,),
                         scaleoffset=0)
        f.create_dataset("seq", shape=(2,), dtype=h5py.vlen_dtype(np.int32))
        f["x"] = np.arange(3)
        f["soft"] = h5py.SoftLink("/x")
        f["ext"] = h5py.ExternalLink("other.h5", "/y")
    with hdf5.File(path) as g:
        # h5py's lzf reads (test_chunked_dataset_reads_like_h5py); the
        # other filters still raise by name
        np.testing.assert_array_equal(g["lzf"][()], np.arange(100))
        with pytest.raises(hdf5.UnsupportedHDF5, match=r"filter 6 \(scaleoffset\)"):
            g["so"]
        with pytest.raises(hdf5.UnsupportedHDF5, match="variable-length sequence"):
            g["seq"]
        assert {"soft", "ext", "x"} <= set(g.keys())
        # a soft link is followed (test_soft_links_read_like_h5py); an
        # external one still raises by name
        np.testing.assert_array_equal(g["soft"][()], np.arange(3))
        with pytest.raises(hdf5.UnsupportedHDF5, match=r"/ext is an external link.*other\.h5"):
            g["ext"]
        np.testing.assert_array_equal(g["x"][()], np.arange(3))


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("userblock", [512, 4096])
def test_a_user_block_reads_like_h5py(tmp_path, libver, userblock):
    """A file h5py writes after a user block (``userblock_size``): libhdf5
    finds the signature at 512, 1024, 2048, ... and counts every address
    from it, so groups (a dense one past 8 links), contiguous and lzf
    chunked datasets of each dtype and a soft link all read as h5py reads
    them, whatever the user block holds."""
    rng = np.random.default_rng(userblock)
    path = str(tmp_path / "u.h5")
    with h5py.File(path, "w", libver=libver, userblock_size=userblock) as f:
        for dt in DTYPES:
            data = make_data(dt, (300, 7) if dt not in ("S", "vlen") else (300,), rng)
            create(f, f"contiguous/{dt}", data)
            create(f, f"chunked/{dt}", data, chunks=(128, 4)[:data.ndim],
                   compression="lzf", shuffle=True)
        for i in range(12):
            f[f"many/d{i}"] = np.arange(i)
        f["soft"] = h5py.SoftLink("/contiguous/u8")
    with open(path, "r+b") as fh:
        fh.write(b"a user block: anything but the signature " * 4)
    with h5py.File(path, "r") as f:
        assert f.userblock_size == userblock
    for group in ("contiguous", "chunked"):
        for dt in DTYPES:
            assert_reads_like_h5py(path, f"{group}/{dt}", rng)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g.keys() == sorted(f.keys()) and g["many"].keys() == sorted(f["many"].keys())
        assert_same(g["many/d11"][()], f["many/d11"][()])
        assert_same(g["soft"][()], f["contiguous/u8"][()])


def test_the_signature_is_looked_for_only_where_libhdf5_looks(tmp_path):
    """At 0, 512, 1024, ... within the file: one that lies past the file's
    end (a user-block file cut short) or at another offset is "not an HDF5
    file", as h5py says; one found where the superblock's base address does
    not say it lies raises by name."""
    plain = str(tmp_path / "plain.h5")
    with h5py.File(plain, "w") as f:
        f["x"] = np.arange(5)
    with open(plain, "rb") as fh:
        body = fh.read()
    with h5py.File(str(tmp_path / "ub.h5"), "w", userblock_size=4096) as f:
        f["x"] = np.arange(5)
    with open(str(tmp_path / "ub.h5"), "rb") as fh:
        cut = fh.read()[:3000]
    for name, blob in (("cut.h5", cut), ("at100.h5", bytes(100) + body),
                       ("at768.h5", bytes(768) + body)):
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            fh.write(blob)
        with pytest.raises(OSError):
            h5py.File(path, "r")
        with pytest.raises(OSError, match="not an HDF5 file"):
            hdf5.File(path)
    moved = str(tmp_path / "moved.h5")
    with open(moved, "wb") as fh:
        fh.write(bytes(512) + body)
    with pytest.raises(hdf5.UnsupportedHDF5,
                       match="base address 0 is not the signature's offset 512"):
        hdf5.File(moved)


@pytest.mark.parametrize("libver", LIBVERS)
def test_a_lone_soft_link_reads_like_h5py(tmp_path, libver):
    """With no other kind of link in the group, the earliest format keeps
    the soft link in its symbol table (cache type 2, the target in the
    local heap), the newest in a link message."""
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f["x"] = np.arange(3)
        f["soft"] = h5py.SoftLink("/x")
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g.keys() == sorted(f.keys())
        np.testing.assert_array_equal(g["soft"][()], f["soft"][()])


@pytest.mark.parametrize("libver", LIBVERS)
def test_soft_links_read_like_h5py(tmp_path, libver):
    """Soft links to a group, relative ones, chains of them and through
    them to a dataset read as h5py reads them; a dangling one is a
    ``KeyError``, as in h5py."""
    path = str(tmp_path / "s.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_group("g/h")["y"] = np.arange(4.0)
        f["g/rel"] = h5py.SoftLink("h/y")
        f["to_group"] = h5py.SoftLink("/g")
        f["chain"] = h5py.SoftLink("/to_group/h")
        f["dangling"] = h5py.SoftLink("/nowhere")
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert isinstance(g["to_group"], hdf5.Group)
        assert g["to_group"].keys() == sorted(f["to_group"].keys())
        for key in ("g/rel", "to_group/rel", "to_group/h/y", "chain/y"):
            np.testing.assert_array_equal(g[key][()], f[key][()])
        for h in (f, g):
            with pytest.raises(KeyError):
                h["dangling"]


@pytest.mark.parametrize("libver", LIBVERS)
def test_fixed_length_strings_of_each_pad_type_read_like_h5py(tmp_path, libver):
    """Null-terminated, null-padded and space-padded strings (pad types 0,
    1 and 2); a space-padded one reads with its trailing spaces stripped,
    as libhdf5 converts it."""
    path = str(tmp_path / "p.h5")
    values = np.array([b"chr1", b"a b ", b"xyzw  q", b""], dtype="S12")
    pads = {"nullterm": h5py.h5t.STR_NULLTERM, "nullpad": h5py.h5t.STR_NULLPAD,
            "spacepad": h5py.h5t.STR_SPACEPAD}
    with h5py.File(path, "w", libver=libver) as f:
        for name, pad in pads.items():
            t = h5py.h5t.C_S1.copy()
            t.set_size(12)
            t.set_strpad(pad)
            space = h5py.h5s.create_simple(values.shape)
            d = h5py.h5d.create(f.id, name.encode(), t, space)
            d.write(h5py.h5s.ALL, h5py.h5s.ALL, values)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        for name in pads:
            want = f[name][()]
            for got in (g[name][()], g[name][1:3], g[name][np.array([2, 0])]):
                assert got.dtype == want.dtype
            assert g[name][()].tolist() == want.tolist()
            assert g[name][1:3].tolist() == want[1:3].tolist()
            assert g[name][np.array([2, 0])].tolist() == want[[2, 0]].tolist()
        assert g["spacepad"][()].tolist() == [b"chr1", b"a b", b"xyzw  q", b""]


def test_rows_decode_each_chunk_once_and_reuse_it_across_calls(tmp_path, monkeypatch):
    """A row read decodes only the chunks its rows lie in, each once; the
    next read that shares a chunk takes it from the cache; a whole read
    caches nothing."""
    path = str(tmp_path / "c.h5")
    data = np.arange(1000 * 6, dtype=np.int64).reshape(1000, 6)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(100, 6), compression="gzip")
    calls = []
    real = _hdf5_chunks.decode
    monkeypatch.setattr(_hdf5_chunks, "decode",
                        lambda p, raw, mask, where: calls.append(where) or real(p, raw, mask, where))
    with hdf5.File(path) as g:
        x = g["x"]
        np.testing.assert_array_equal(x[150:420], data[150:420])
        assert len(calls) == 4  # chunks 1-4
        np.testing.assert_array_equal(x[420:480], data[420:480])
        assert len(calls) == 4  # chunk 4 again: cached
        rows = np.array([999, 5, 7, 998, 5])
        np.testing.assert_array_equal(x[rows], data[rows])
        assert len(calls) == 6  # chunks 9 and 0, once each
        calls.clear()
        np.testing.assert_array_equal(x[()], data)
        assert len(calls) == 10


def test_the_chunk_cache_is_safe_across_threads(tmp_path, monkeypatch):
    """Eight threads read rows of one open file through a cache smaller than
    their chunks, evicting each other's."""
    monkeypatch.setattr(_hdf5_chunks, "CACHE_BYTES", 3 * 100 * 6 * 8)
    path = str(tmp_path / "t.h5")
    data = np.arange(2000 * 6, dtype=np.int64).reshape(2000, 6)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(100, 6), compression="gzip", shuffle=True)
    errors = []
    with hdf5.File(path) as g:
        x = g["x"]

        def work(seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(60):
                    lo = int(rng.integers(0, 1900))
                    np.testing.assert_array_equal(x[lo:lo + 150], data[lo:lo + 150])
                    rows = rng.integers(0, 2000, 30)
                    np.testing.assert_array_equal(x[rows], data[rows])
            except Exception as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert x._layout[1]._cache_bytes <= 3 * 100 * 6 * 8
    assert not errors, errors[0]


def fletcher32_reference(data: bytes) -> int:
    """H5_checksum_fletcher32, transcribed: 360-word blocks, folded sums."""
    n, s1, s2, i = len(data) // 2, 0, 0, 0
    while n:
        t = min(n, 360)
        n -= t
        for _ in range(t):
            s1 += data[i] << 8 | data[i + 1]
            i += 2
            s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[i] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return s2 << 16 | s1


@settings(max_examples=40, deadline=None)
@given(st.one_of(st.binary(max_size=3000),
                 st.integers(0, 2000).map(lambda n: b"\xff" * n)))
def test_fletcher32_equals_libhdf5s_loop(data):
    assert _hdf5_filters.fletcher32(data) == fletcher32_reference(data)


@settings(max_examples=25, deadline=None)
@given(st.binary(max_size=500), st.sampled_from([1, 2, 3, 4, 8, 16]))
def test_unshuffle_inverts_the_byte_transpose(data, size):
    n = len(data) // size
    planes = np.frombuffer(data, np.uint8, n * size).reshape(n, size).T.tobytes()
    assert _hdf5_filters.unshuffle(planes + data[n * size:], size) == data


def test_lookup3_known_values():
    # Bob Jenkins' published values for hashlittle
    assert lookup3(b"") == 0xDEADBEEF
    assert lookup3(b"Four score and seven years ago") == 0x17770551
    assert lookup3(b"Four score and seven years ago", 1) == 0xCD628161
    assert lookup3(struct.pack("<12I", *range(12))) == lookup3(bytearray(struct.pack(
        "<12I", *range(12))))
