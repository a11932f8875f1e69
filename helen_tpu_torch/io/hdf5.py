"""A pure-Python reader and writer for the HDF5 files the port reads and writes.

The machine the port runs on need not have h5py (the H100 hosts it targets
do not), so the image files, the packed image cache, the prediction store
and the synthetic-data writer go through this module instead. It reads what
libhdf5 (h5py, helen_tpu, MarginPolish) writes for those files, in the
earliest format and in the newest (``libver="latest"``):

* superblock versions 0-3, 8-byte offsets and lengths; the checksums of the
  newer metadata (Jenkins lookup3) verified, a mismatch an ``OSError``;
* a user block before the superblock: the signature looked for at 0, 512,
  1024, 2048 and so on, as libhdf5 does, and every address read from that
  base;
* object headers of version 1 and 2, with continuation blocks;
* groups as symbol tables (a version-1 B-tree over symbol-table nodes, names
  in a local heap), or new-style: link messages in the header (compact) or
  in a fractal heap indexed by a version-2 B-tree of names (dense, which
  h5py uses past 8 links); hard and soft links (followed as libhdf5 follows
  them), an external link raises on access;
* datasets of little- or big-endian integers, IEEE floats, fixed-length byte
  strings and variable-length strings (from the global heap, as ``bytes``),
  scalar or n-dimensional, with dataspace versions 1-2, datatype versions
  1-3 and layout versions 3-4: compact, contiguous or chunked, a chunk
  found through any of HDF5's indexes (io._hdf5_chunks) and filtered by
  deflate, shuffle, fletcher32 or h5py's lzf (io._hdf5_filters); a chunk
  never written reads as the fill value.

Anything else raises :class:`UnsupportedHDF5` naming it: other filters
(szip, n-bit, scale-offset, ...), variable-length sequences, compound, enum
and array types, virtual datasets, shared (committed) datatypes, and heap
objects other than managed ones (io._hdf5_v2).

:class:`File` reads through a memory map and mirrors the small part of the
h5py API the port calls (``f["a/b"]``, ``in``, ``keys()``, ``items()``,
``dset[()]``, and on the first axis ``dset[a:b]`` and ``dset[index_array]``,
which read only those rows, and of a chunked dataset only the chunks they
lie in). :class:`Writer` builds a file in the earliest format that libhdf5
(h5py, helen_tpu) reads back: dataset payloads go to disk as they are
created, or are reserved at their full shape and written by rows later
(:meth:`WGroup.create_dataset`); the metadata — object headers, local heaps,
B-trees, symbol-table nodes and the superblock — is written at
:meth:`Writer.close`, the superblock last, so a file is readable once closed.
:meth:`Writer.reopen` continues a file that was never closed: the bytes past
a given end are cut, new payloads go after it, and :meth:`WGroup.link` adds
the datasets whose payloads are already there.
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from helen_tpu_torch.io import _hdf5_v2
from helen_tpu_torch.io._hdf5_chunks import Chunked
from helen_tpu_torch.io._hdf5_filters import parse_pipeline
from helen_tpu_torch.io._hdf5_v2 import UNDEF, UnsupportedHDF5

SIGNATURE = b"\x89HDF\r\n\x1a\n"
# B-tree / symbol-table node widths (HDF5 defaults): a symbol-table node
# holds up to 2 * LEAF_K entries, a B-tree node up to 2 * INTERNAL_K children
LEAF_K = 4
INTERNAL_K = 16
_SB_SIZE = 96  # superblock v0 with 8-byte offsets, root entry included

# object header message types
_MSG_DATASPACE = 0x0001
_MSG_LINK_INFO = 0x0002
_MSG_DATATYPE = 0x0003
_MSG_FILL = 0x0005
_MSG_LINK = 0x0006
_MSG_LAYOUT = 0x0008
_MSG_FILTERS = 0x000B
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011
_GROUP_MSGS = {_MSG_SYMBOL_TABLE, _MSG_LINK_INFO, _MSG_LINK}
# a shared (committed) copy of these would be elsewhere in the file
_UNSHARED = {_MSG_DATASPACE, _MSG_DATATYPE, _MSG_FILL, _MSG_FILTERS, _MSG_LAYOUT}
# a variable-length string's record: length, global heap collection, index
_VLEN = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
# nested soft links followed before a lookup fails (libhdf5's H5L_NUM_LINKS)
MAX_SOFT_LINKS = 16


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class Dataset:
    def __init__(self, f: "File", name: str, messages):
        self.name = name
        mm = f._mm
        space = dtype = layout = fill = None
        pipeline = []
        for mtype, p, size in messages:
            if mtype == _MSG_DATASPACE:
                space = p
            elif mtype == _MSG_DATATYPE:
                dtype = p
            elif mtype == _MSG_LAYOUT:
                layout = p
            elif mtype == _MSG_FILL:
                fill = p
            elif mtype == _MSG_FILTERS:
                pipeline = parse_pipeline(mm, p, f"{f.filename}: {name}")
        if space is None or dtype is None or layout is None:
            raise UnsupportedHDF5(f"{name}: not a dataset this reader knows")
        self.shape, maxshape = _read_dataspace(mm, space, name)
        self._raw = _read_datatype(mm, dtype, name)  # the stored element
        self._vlen = self._raw is _VLEN
        # a space-padded string (class 3, pad type 2) reads with its padding
        # stripped, as libhdf5 converts it to numpy's null-padded strings
        self._spacepad = mm[dtype] & 0x0F == 3 and mm[dtype + 1] & 0x0F == 2
        self.dtype = np.dtype(object) if self._vlen else self._raw
        self._f = f
        self._fill_at = fill  # the fill value message, read where needed
        version, cls = mm[layout], mm[layout + 1]
        if version not in (3, 4):
            raise UnsupportedHDF5(f"{name}: layout message version {version}")
        if cls == 0:
            size, = struct.unpack_from("<H", mm, layout + 2)
            self._layout = ("compact", layout + 4, size)
        elif cls == 1:
            self._layout = ("contiguous",) + struct.unpack_from("<QQ", mm, layout + 2)
        elif cls == 2:
            self._layout = ("chunked", Chunked(f, name, layout, self.shape, maxshape,
                                               self._raw, pipeline, self._fill()), 0)
        else:
            raise UnsupportedHDF5(f"{name}: virtual dataset layout")

    def __getitem__(self, key) -> np.ndarray:
        """``dset[()]`` (the whole dataset), or rows of the first axis:
        ``dset[a:b]`` or ``dset[index_array]`` (any order, repeats allowed),
        which copy only those rows out of the map. Variable-length strings
        come back as ``bytes`` (a scalar) or an object array of them."""
        whole = isinstance(key, tuple) and key == () or key is Ellipsis
        if not whole:
            if not self.shape:
                raise UnsupportedHDF5(f"{self.name}: row reads of a scalar dataset")
            if isinstance(key, slice):
                if key.step not in (None, 1):
                    raise UnsupportedHDF5("only unit-step row slices are supported")
            else:
                key = np.asarray(key)
                if key.ndim != 1 or key.dtype.kind not in "iu":
                    raise UnsupportedHDF5("row reads take a slice or a 1-D integer array")
        count = int(np.prod(self.shape, dtype=np.int64))
        kind, where, nbytes = self._layout
        if count == 0 or (kind == "contiguous" and where == UNDEF):
            fill = self._fill()
            value = np.frombuffer(fill, self._raw, 1)[0] if fill else np.zeros((), self._raw)
            out = np.full(self.shape, value, dtype=self._raw)[() if whole else key]
        elif kind == "chunked":
            out = where.read(None if whole else key)
        else:
            if nbytes < count * self._raw.itemsize:
                raise UnsupportedHDF5(f"{self.name}: storage smaller than its shape")
            view = np.frombuffer(self._f._mm, dtype=self._raw, count=count,
                                 offset=where).reshape(self.shape)
            out = np.array(view if whole else view[key], copy=True)
            del view  # release the buffer export so the map can close
        if self._spacepad:
            return np.char.rstrip(out, b" ").astype(self._raw)
        return self._f._strings(out) if self._vlen else out

    def _fill(self) -> Optional[bytes]:
        if self._fill_at is None:
            return None
        return _read_fill(self._f._mm, self._fill_at, self._raw.itemsize)


class Group:
    def __init__(self, f: "File", addr: int, name: str, messages=None):
        self._f = f
        self.name = name
        self._links: Union[Dict[str, _hdf5_v2.Link], None] = None
        self._addr = addr
        self._msgs = messages  # the header's messages, until the table is read

    def _table(self) -> Dict[str, _hdf5_v2.Link]:
        if self._links is None:
            self._links = self._f._group_links(self._addr, self.name, self._msgs)
            self._msgs = None
        return self._links

    def keys(self) -> List[str]:
        return sorted(self._table())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        return self._walk(path, 0)

    def _walk(self, path: str, depth: int):
        """The object at ``path`` (absolute, or relative to this group),
        following soft links as libhdf5 does, at most
        :data:`MAX_SOFT_LINKS` deep; a dangling one is a ``KeyError``."""
        node = self._f if path.startswith("/") else self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(path)
            addr = node._table().get(part)
            if addr is None:
                raise KeyError(f"{part!r} not in {node.name!r}")
            full = f"{node.name.rstrip('/')}/{part}"
            if isinstance(addr, _hdf5_v2.SoftLink):
                if depth >= MAX_SOFT_LINKS:
                    raise KeyError(f"{full}: more than {MAX_SOFT_LINKS} nested soft links")
                node = node._walk(addr, depth + 1)
            elif isinstance(addr, str):
                raise UnsupportedHDF5(f"{full} is {addr}: only hard and soft links are read")
            else:
                node = node._f._node(addr, full)
        return node


def signature_offset(mm) -> Optional[int]:
    """Where the superblock starts: the first of 0, 512, 1024, 2048, ... at
    which the file holds the signature (libhdf5's H5FD_locate_signature),
    None if none does. A user block fills the bytes before it."""
    at = 0
    while at + len(SIGNATURE) <= len(mm):
        if mm[at:at + len(SIGNATURE)] == SIGNATURE:
            return at
        at = at * 2 or 512
    return None


class _Shifted:
    """The file's bytes from ``base`` on, where a user block of ``base``
    bytes comes first: HDF5's addresses count from the superblock. Indexing
    and slicing read like the map's (an int, ``bytes``), and the buffer it
    exports (``struct.unpack_from``, ``np.frombuffer``) starts at ``base``.
    A map cannot start there itself: its offset must be a multiple of the
    page size."""

    def __init__(self, mm: mmap.mmap, base: int):
        self._mm, self._base = mm, base

    def __len__(self) -> int:
        return len(self._mm) - self._base

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(len(self))
            return self._mm[self._base + start:self._base + stop:step]
        return self._mm[self._base + (key if key >= 0 else key + len(self))]

    def find(self, sub: bytes, start: int = 0) -> int:
        at = self._mm.find(sub, self._base + start)
        return at - self._base if at >= 0 else -1

    def __buffer__(self, flags: int) -> memoryview:
        return memoryview(self._mm)[self._base:]

    def close(self) -> None:
        self._mm.close()


class File(Group):
    """Read-only HDF5 file (see the module docstring for the subset)."""

    def __init__(self, path: str):
        self.filename = path
        self._fh = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as exc:  # empty file
            self._fh.close()
            raise OSError(f"{path}: not an HDF5 file ({exc})") from exc
        self._nodes: Dict[int, Union[Group, Dataset]] = {}
        self._heaps: Dict[int, Dict[int, Tuple[int, int]]] = {}
        try:
            root = self._root_address()
        except BaseException:
            self.close()
            raise
        super().__init__(self, root, "/")

    def _root_address(self) -> int:
        """The root group's address, read from the superblock, after which
        ``self._mm`` reads from the superblock on (:class:`_Shifted`)."""
        base = signature_offset(self._mm)
        if base is None:
            raise OSError(f"{self.filename}: not an HDF5 file (no signature at 0, 512, "
                          f"1024, ... up to its {len(self._mm)} bytes)")
        mm = self._mm = _Shifted(self._mm, base) if base else self._mm
        version = mm[8]
        if version not in (0, 1, 2, 3):
            raise UnsupportedHDF5(f"superblock version {version}")
        sizes = (mm[13], mm[14]) if version < 2 else (mm[9], mm[10])
        if sizes != (8, 8):
            raise UnsupportedHDF5("offset/length sizes other than 8 bytes")
        # the superblock's base address, which every other address counts
        # from: libhdf5 writes the user block's size there
        stored, = struct.unpack_from("<Q", mm, (24, 28, 12, 12)[version])
        if stored != base:
            raise UnsupportedHDF5(f"{self.filename}: superblock base address {stored} is "
                                  f"not the signature's offset {base}")
        if version < 2:
            entry = 56 if version == 0 else 60
            return struct.unpack_from("<Q", mm, entry + 8)[0]
        return _hdf5_v2.superblock_root(self)

    def _messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, data offset, size) of each message of an object header
        (version 1, or version 2 with its checksums verified)."""
        mm = self._mm
        if mm[addr] != 1:
            if mm[addr:addr + 4] != b"OHDR":
                raise UnsupportedHDF5(f"object header version {mm[addr]} at {addr}")
            out = []
            for mtype, p, size, flags in _hdf5_v2.ohdr_messages(self, addr, _MSG_CONTINUATION):
                if flags & 0x02 and mtype in _UNSHARED:
                    raise UnsupportedHDF5(f"shared (committed) message {mtype:#06x} at {addr}")
                out.append((mtype, p, size))
            return out
        nmsgs, = struct.unpack_from("<H", mm, addr + 2)
        hsize, = struct.unpack_from("<I", mm, addr + 8)
        blocks = [(addr + 16, hsize)]
        out: List[Tuple[int, int, int]] = []
        seen = 0
        while blocks and seen < nmsgs:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end and seen < nmsgs:
                mtype, msize = struct.unpack_from("<HH", mm, p)
                seen += 1
                if mtype == _MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", mm, p + 8))
                else:
                    if mm[p + 4] & 0x02 and mtype in _UNSHARED:
                        raise UnsupportedHDF5(f"shared (committed) message {mtype:#06x} "
                                              f"at {addr}")
                    out.append((mtype, p + 8, msize))
                p += 8 + msize
        return out

    def _node(self, addr: int, name: str):
        node = self._nodes.get(addr)
        if node is None:
            msgs = self._messages(addr)
            node = (Group(self, addr, name, msgs) if _GROUP_MSGS & {m[0] for m in msgs}
                    else Dataset(self, name, msgs))
            self._nodes[addr] = node
        return node

    def _group_links(self, addr: int, name: str, msgs=None) -> Dict[str, _hdf5_v2.Link]:
        """A group's links: its symbol table (the earliest format), or its
        link messages and its link-info message's dense storage."""
        msgs = self._messages(addr) if msgs is None else msgs
        stab = [p for t, p, _ in msgs if t == _MSG_SYMBOL_TABLE]
        if stab:
            return self._symbol_table(stab[0], name)
        links: Dict[str, _hdf5_v2.Link] = {}
        for t, p, _ in msgs:
            if t == _MSG_LINK:
                link, target = _hdf5_v2.parse_link(self._mm, p)
                links[link] = target
            elif t == _MSG_LINK_INFO:
                links.update(_hdf5_v2.dense_links(self, p))
        if not links and _MSG_LINK_INFO not in {t for t, _, _ in msgs}:
            raise UnsupportedHDF5(f"{name}: not a group this reader knows")
        return links

    def _symbol_table(self, stab: int, name: str) -> Dict[str, int]:
        mm = self._mm
        btree, heap = struct.unpack_from("<QQ", mm, stab)
        if mm[heap:heap + 4] != b"HEAP":
            raise OSError(f"{name}: bad local heap at {heap}")
        heap_data, = struct.unpack_from("<Q", mm, heap + 24)
        links: Dict[str, int] = {}
        for snod in self._btree_leaves(btree):
            if mm[snod:snod + 4] != b"SNOD":
                raise OSError(f"{name}: bad symbol-table node at {snod}")
            nsyms, = struct.unpack_from("<H", mm, snod + 6)
            for i in range(nsyms):
                entry = snod + 8 + 40 * i
                off, obj, cache = struct.unpack_from("<QQI", mm, entry)
                link = self._heap_string(heap_data + off)
                if cache == 2:  # a soft link: its target's offset in the heap
                    target, = struct.unpack_from("<I", mm, entry + 24)
                    obj = _hdf5_v2.SoftLink(self._heap_string(heap_data + target))
                links[link] = obj
        return links

    def _heap_string(self, start: int) -> str:
        return self._mm[start:self._mm.find(b"\0", start)].decode()

    def _btree_leaves(self, addr: int) -> Iterator[int]:
        mm = self._mm
        if mm[addr:addr + 4] != b"TREE" or mm[addr + 4] != 0:
            raise OSError(f"bad group B-tree node at {addr}")
        level = mm[addr + 5]
        used, = struct.unpack_from("<H", mm, addr + 6)
        for i in range(used):
            child, = struct.unpack_from("<Q", mm, addr + 24 + 8 + 16 * i)
            if level:
                yield from self._btree_leaves(child)
            else:
                yield child

    def _strings(self, records: np.ndarray):
        """The variable-length strings ``records`` point at in the global
        heap: ``bytes`` for a scalar, else an object array of ``bytes``."""
        out = np.empty(records.shape, dtype=object)
        flat = out.reshape(-1)
        for i, (length, addr, idx) in enumerate(records.reshape(-1).tolist()):
            if length == 0:
                flat[i] = b""
                continue
            at, size = self._heap_object(addr, idx)
            flat[i] = self._mm[at:at + min(length, size)]
        return out[()] if out.ndim == 0 else out

    def _heap_object(self, addr: int, idx: int) -> Tuple[int, int]:
        """(offset, size) of object ``idx`` of the global heap collection at
        ``addr``."""
        objects = self._heaps.get(addr)
        if objects is None:
            mm = self._mm
            if mm[addr:addr + 4] != b"GCOL":
                raise OSError(f"{self.filename}: bad global heap collection at {addr}")
            size, = struct.unpack_from("<Q", mm, addr + 8)
            objects, p, end = {}, addr + 16, addr + size
            while p + 16 <= end:
                index, = struct.unpack_from("<H", mm, p)
                osize, = struct.unpack_from("<Q", mm, p + 8)
                if index == 0:  # the free space that ends the collection
                    break
                objects[index] = (p + 16, osize)
                p += 16 + osize + (-osize % 8)
            self._heaps[addr] = objects
        try:
            return objects[idx]
        except KeyError:
            raise OSError(f"{self.filename}: no object {idx} in the global heap "
                          f"collection at {addr}") from None

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._fh.close()
            self._mm = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_dataspace(mm, p: int, name: str):
    """(shape, largest shape: None on an unlimited axis)."""
    version, rank, flags = mm[p], mm[p + 1], mm[p + 2]
    if version == 1:
        dims = p + 8
    elif version == 2:
        if mm[p + 3] == 2:  # null dataspace
            return (0,), (0,)
        dims = p + 4
    else:
        raise UnsupportedHDF5(f"{name}: dataspace version {version}")
    if not rank:
        return (), ()
    shape = struct.unpack_from(f"<{rank}Q", mm, dims)
    if not flags & 0x01:
        return shape, shape
    top = struct.unpack_from(f"<{rank}Q", mm, dims + 8 * rank)
    return shape, tuple(None if m == UNDEF else m for m in top)


def _read_datatype(mm, p: int, name: str) -> np.dtype:
    """The stored element's dtype (:data:`_VLEN` for a variable-length
    string's record)."""
    version, cls, bits = mm[p] >> 4, mm[p] & 0x0F, mm[p + 1]
    size, = struct.unpack_from("<I", mm, p + 4)
    if version not in (1, 2, 3):
        raise UnsupportedHDF5(f"{name}: datatype version {version}")
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    if cls == 9:
        if bits & 0x0F != 1:
            raise UnsupportedHDF5(f"{name}: variable-length sequence datatype")
        if size != _VLEN.itemsize:
            raise UnsupportedHDF5(f"{name}: variable-length string of size {size}")
        return _VLEN
    raise UnsupportedHDF5(f"{name}: datatype class {cls} (size {size})")


def _read_fill(mm, p: int, itemsize: int) -> Optional[bytes]:
    """The fill value's bytes (message 0x0005, versions 1-3); None where it
    is undefined or the default (zeros)."""
    version = mm[p]
    if version in (1, 2):
        if version == 2 and not mm[p + 3]:
            return None
        q = p + 4
    elif version == 3:
        if not mm[p + 1] & 0x20:
            return None
        q = p + 2
    else:
        raise UnsupportedHDF5(f"fill value message version {version}")
    size, = struct.unpack_from("<I", mm, q)
    if size != itemsize:
        return None
    return mm[q + 4:q + 4 + size]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class _WDataset:
    """A dataset being written. One made by :meth:`WGroup.create_dataset`
    has its storage reserved and takes rows: ``dset[a:b] = rows``."""

    def __init__(self, shape, dtype: np.dtype, addr: int, nbytes: int,
                 writer: "Writer" = None):
        self.shape, self.dtype, self.addr, self.nbytes = shape, dtype, addr, nbytes
        self._w = writer

    def __setitem__(self, key, value) -> None:
        if self._w is None or not isinstance(key, slice) or key.step not in (None, 1):
            raise UnsupportedHDF5("row writes (dset[a:b] = rows) need a reserved dataset")
        lo, hi, _ = key.indices(self.shape[0])
        rows = np.ascontiguousarray(value, dtype=self.dtype)
        if rows.shape != (hi - lo,) + tuple(self.shape[1:]):
            raise ValueError(f"rows of shape {rows.shape} for [{lo}:{hi}] of {self.shape}")
        row_bytes = self.nbytes // max(1, self.shape[0])
        self._w._pwrite(self.addr + lo * row_bytes, rows.tobytes())


def _check_dtype(dtype: np.dtype) -> None:
    if dtype.kind not in "iufS" or dtype.kind == "f" and dtype.itemsize not in (4, 8):
        raise UnsupportedHDF5(f"dataset dtype {dtype}")


class WGroup:
    """A group being written: ``create_group(path)``, ``g[name] = array``,
    ``create_dataset(name, shape, dtype)``."""

    def __init__(self, writer: "Writer"):
        self._w = writer
        self.children: Dict[str, Union["WGroup", _WDataset]] = {}

    def _walk(self, path: str) -> "WGroup":
        """The group at ``path``, creating the groups missing on the way."""
        node = self
        for part in (p for p in path.split("/") if p):
            child = node.children.get(part)
            if child is None:
                child = node.children[part] = WGroup(self._w)
            if not isinstance(child, WGroup):
                raise KeyError(f"{path}: {part!r} is a dataset")
            node = child
        return node

    def __contains__(self, name: str) -> bool:
        return name in self.children

    def create_group(self, path: str) -> "WGroup":
        parent, _, name = path.strip("/").rpartition("/")
        node = self._walk(parent)
        if name in node.children:
            raise ValueError(f"{path!r} already exists")
        return node._walk(name)

    def _add(self, name: str, d: _WDataset) -> _WDataset:
        if "/" in name or name in self.children:
            raise ValueError(f"cannot create dataset {name!r} here")
        self.children[name] = d
        return d

    def __setitem__(self, name: str, value) -> None:
        arr = np.asarray(value)
        _check_dtype(arr.dtype)
        self._add(name, _WDataset(arr.shape, arr.dtype, *self._w._append(arr)))

    def __getitem__(self, name: str) -> _WDataset:
        d = self.children[name]
        if not isinstance(d, _WDataset):
            raise KeyError(f"{name!r} is not a dataset written in this session")
        return d

    def link(self, name: str, shape, dtype, addr: int) -> _WDataset:
        """A dataset whose payload is already in the file at ``addr`` (a
        writer recovering its records from a journal)."""
        dtype = np.dtype(dtype)
        _check_dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return self._add(name, _WDataset(tuple(shape), dtype,
                                         addr if nbytes else UNDEF, nbytes))

    def create_dataset(self, name: str, shape, dtype) -> _WDataset:
        """Reserve a contiguous dataset at its full shape; write its rows
        later with ``dset[a:b] = rows`` (rows never written read as zeros)."""
        dtype = np.dtype(dtype)
        _check_dtype(dtype)
        shape = tuple(int(s) for s in shape)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        addr = self._w._reserve(nbytes) if nbytes else UNDEF
        return self._add(name, _WDataset(shape, dtype, addr, nbytes, self._w))


class Writer(WGroup):
    """Write a new HDF5 file, or continue one never closed (:meth:`reopen`);
    see the module docstring."""

    def __init__(self, path: str, _end: int = None):
        super().__init__(self)
        if _end is None:
            self._fh = open(path, "wb")
            self._fh.write(b"\0" * _SB_SIZE)  # superblock, written at close
            self._end = _SB_SIZE
        else:
            self._fh = open(path, "r+b")
            self._fh.truncate(_end)
            self._fh.seek(0)
            self._fh.write(b"\0" * _SB_SIZE)  # never mistaken for a closed file
            self._fh.seek(_end)
            self._end = _end

    @classmethod
    def reopen(cls, path: str, end: int) -> "Writer":
        """Continue writing ``path`` past byte ``end`` (the file is cut
        there) with an empty root: the caller links what it keeps."""
        return cls(path, _end=max(end, _SB_SIZE))

    def _append(self, arr: np.ndarray) -> Tuple[int, int]:
        if arr.nbytes == 0:
            return UNDEF, 0
        addr = self._end
        self._fh.write(arr.tobytes())
        self._end += arr.nbytes
        return addr, arr.nbytes

    def _put(self, blob: bytes) -> int:
        addr = self._end
        self._fh.write(blob)
        self._end += len(blob)
        return addr

    def _reserve(self, nbytes: int) -> int:
        addr = self._end
        self._end += nbytes
        self._fh.seek(self._end)  # the hole reads as zeros until written
        return addr

    def _pwrite(self, addr: int, data: bytes) -> None:
        self._fh.flush()
        os.pwrite(self._fh.fileno(), data, addr)

    def flush(self) -> None:
        """Push dataset payloads to the OS (the file is readable only after
        :meth:`close` writes the metadata)."""
        self._fh.flush()

    def fileno(self) -> int:
        return self._fh.fileno()

    def sync(self) -> None:
        """:meth:`flush`, then wait until the OS has them on disk."""
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self, sync: bool = False) -> None:
        """Write the metadata, then the superblock (``sync``: then wait until
        the OS has the file on disk)."""
        if self._fh is None:
            return
        root, btree, heap = self._write_group(self)
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, self._end, UNDEF)
              # root symbol-table entry, with the root's B-tree and heap cached
              + struct.pack("<QQII", 0, root, 1, 0) + struct.pack("<QQ", btree, heap))
        self._pwrite(0, sb)
        if sync:
            os.fsync(self._fh.fileno())
        self._fh.close()
        self._fh = None

    def abandon(self) -> None:
        """Close the file without writing any metadata."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "Writer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _write_group(self, g: WGroup) -> Tuple[int, int, int]:
        """Write a group's children, then its heap, symbol-table nodes,
        B-tree and object header; returns (header, B-tree, heap) addresses."""
        addrs = {name: (self._write_group(c)[0] if isinstance(c, WGroup)
                        else self._write_dataset(c))
                 for name, c in g.children.items()}
        # local heap: offset 0 is the empty name; names null-terminated and
        # padded to 8 bytes; one trailing free block (libhdf5 expects a free
        # list that is either empty or inside the segment)
        names = sorted(addrs, key=lambda s: s.encode())
        data = bytearray(b"\0" * 8)
        offset = {}
        for n in names:
            offset[n] = len(data)
            b = n.encode() + b"\0"
            data += b + b"\0" * (-len(b) % 8)
        free = len(data)
        data += struct.pack("<QQ", 1, 16)  # free block: next = none (1), 16 bytes
        heap_data = self._put(bytes(data))
        heap = self._put(b"HEAP" + bytes(4) + struct.pack("<QQQ", len(data), free, heap_data))
        # symbol-table nodes of at most 2 * LEAF_K sorted entries
        width = 2 * LEAF_K
        children: List[Tuple[int, str]] = []  # (node address, its last name)
        for i in range(0, len(names), width):
            chunk = names[i:i + width]
            body = b"".join(struct.pack("<QQII", offset[n], addrs[n], 0, 0) + bytes(16)
                            for n in chunk)
            body += bytes(40 * (width - len(chunk)))
            addr = self._put(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(chunk)) + body)
            children.append((addr, chunk[-1] if chunk else ""))
        # B-tree levels of at most 2 * INTERNAL_K children, bottom-up (an
        # empty group gets one node with no children)
        level = 0
        while True:
            fan = 2 * INTERNAL_K
            parents = []
            for i in range(0, max(len(children), 1), fan):
                kids = children[i:i + fan]
                body = struct.pack("<Q", 0)
                for addr, last in kids:
                    body += struct.pack("<QQ", addr, offset.get(last, 0))
                body += bytes(16 * (fan - len(kids)))
                node = self._put(b"TREE" + bytes([0, level]) + struct.pack("<H", len(kids))
                                 + struct.pack("<QQ", UNDEF, UNDEF) + body)
                parents.append((node, kids[-1][1] if kids else ""))
            if len(parents) == 1:
                btree = parents[0][0]
                break
            children, level = parents, level + 1
        header = self._object_header([(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))])
        return header, btree, heap

    def _write_dataset(self, d: _WDataset) -> int:
        rank = len(d.shape)
        space = bytes([1, rank, 0, 0]) + bytes(4) + struct.pack(f"<{rank}Q", *d.shape)
        dt = d.dtype
        if dt.kind in "iu":
            bits = (1 if dt.byteorder == ">" else 0) | (0x08 if dt.kind == "i" else 0)
            dtype = (bytes([0x10, bits, 0, 0]) + struct.pack("<I", dt.itemsize)
                     + struct.pack("<HH", 0, 8 * dt.itemsize))
        elif dt.kind == "f":
            bits = 1 if dt.byteorder == ">" else 0
            exp, man, bias = (8, 23, 127) if dt.itemsize == 4 else (11, 52, 1023)
            dtype = (bytes([0x11, 0x20 | bits, 8 * dt.itemsize - 1, 0])
                     + struct.pack("<I", dt.itemsize)
                     + struct.pack("<HHBBBBI", 0, 8 * dt.itemsize, man, exp, 0, man, bias))
        else:  # fixed-length byte string, null-padded (numpy "S")
            dtype = bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
        # fill value (as libhdf5 writes it): version 2, late allocation,
        # written if set, defined with size 0 (the default zero fill)
        fill = bytes([2, 2, 2, 1]) + struct.pack("<I", 0)
        layout = bytes([3, 1]) + struct.pack("<QQ", d.addr, d.nbytes)
        return self._object_header([(_MSG_DATASPACE, space), (_MSG_DATATYPE, dtype),
                                    (_MSG_FILL, fill), (_MSG_LAYOUT, layout)])

    def _object_header(self, msgs) -> int:
        body = b""
        for mtype, data in msgs:
            data = data + bytes(-len(data) % 8)
            body += struct.pack("<HHB", mtype, len(data), 0) + bytes(3) + data
        return self._put(bytes([1, 0]) + struct.pack("<HII", len(msgs), 1, len(body))
                         + bytes(4) + body)
