"""A pure-Python reader and writer for the subset of HDF5 the port uses.

The machine the port runs on need not have h5py (the H100 hosts it targets
do not), so the image files, the prediction store and the synthetic-data
writer go through this module instead. It covers what those files use, in
HDF5's original ("earliest") format, the one h5py writes by default:

* superblock version 0 or 1, 8-byte offsets and lengths;
* version-1 object headers, with continuation blocks;
* groups as symbol tables (a version-1 B-tree over symbol-table nodes, with
  names in a local heap);
* datasets of little- or big-endian integers, IEEE floats and fixed-length
  byte strings, scalar or n-dimensional, in contiguous or compact layout.

Anything else (chunked or filtered datasets, new-style groups, variable-length
types, version-2 object headers) raises :class:`UnsupportedHDF5`.

:class:`File` reads through a memory map and mirrors the small part of the
h5py API the port calls (``f["a/b"]``, ``in``, ``keys()``, ``items()``,
``dset[()]``, and on the first axis ``dset[a:b]`` and ``dset[index_array]``,
which read only those rows). :class:`Writer` builds a file that libhdf5
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
from typing import Dict, Iterator, List, Tuple, Union

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
SIGNATURE = b"\x89HDF\r\n\x1a\n"
# B-tree / symbol-table node widths (HDF5 defaults): a symbol-table node
# holds up to 2 * LEAF_K entries, a B-tree node up to 2 * INTERNAL_K children
LEAF_K = 4
INTERNAL_K = 16
_SB_SIZE = 96  # superblock v0 with 8-byte offsets, root entry included

# object header message types
_MSG_DATASPACE = 0x0001
_MSG_DATATYPE = 0x0003
_MSG_FILL = 0x0005
_MSG_LAYOUT = 0x0008
_MSG_FILTERS = 0x000B
_MSG_CONTINUATION = 0x0010
_MSG_SYMBOL_TABLE = 0x0011


class UnsupportedHDF5(ValueError):
    """The file uses an HDF5 feature outside this module's subset."""


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class Dataset:
    def __init__(self, f: "File", addr: int, name: str):
        self.name = name
        mm = f._mm
        space = dtype = layout = None
        for mtype, p, size in f._messages(addr):
            if mtype == _MSG_DATASPACE:
                space = p
            elif mtype == _MSG_DATATYPE:
                dtype = p
            elif mtype == _MSG_LAYOUT:
                layout = p
            elif mtype == _MSG_FILTERS:
                raise UnsupportedHDF5(f"{name}: filtered (compressed) dataset")
        if space is None or dtype is None or layout is None:
            raise UnsupportedHDF5(f"{name}: not a dataset this reader knows")
        self.shape = _read_dataspace(mm, space, name)
        self.dtype = _read_datatype(mm, dtype, name)
        self._f = f
        self._layout = _read_layout(mm, layout, name)

    def __getitem__(self, key) -> np.ndarray:
        """``dset[()]`` (the whole dataset), or rows of the first axis:
        ``dset[a:b]`` or ``dset[index_array]`` (any order, repeats allowed),
        which copy only those rows out of the map."""
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
            return np.zeros(self.shape, dtype=self.dtype)[() if whole else key]
        if nbytes < count * self.dtype.itemsize:
            raise UnsupportedHDF5(f"{self.name}: storage smaller than its shape")
        view = np.frombuffer(self._f._mm, dtype=self.dtype, count=count,
                             offset=where).reshape(self.shape)
        out = np.array(view if whole else view[key], copy=True)
        del view  # release the buffer export so the map can close
        return out


class Group:
    def __init__(self, f: "File", addr: int, name: str):
        self._f = f
        self.name = name
        self._links: Union[Dict[str, int], None] = None
        self._addr = addr

    def _table(self) -> Dict[str, int]:
        if self._links is None:
            self._links = self._f._symbol_table(self._addr, self.name)
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
        node = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(path)
            addr = node._table().get(part)
            if addr is None:
                raise KeyError(f"{part!r} not in {node.name!r}")
            node = node._f._node(addr, f"{node.name.rstrip('/')}/{part}")
        return node


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
        super().__init__(self, self._root_address(), "/")

    def _root_address(self) -> int:
        mm = self._mm
        if mm[:8] != SIGNATURE:
            raise OSError(f"{self.filename}: not an HDF5 file (no signature at 0)")
        version = mm[8]
        if version in (0, 1):
            if mm[13] != 8 or mm[14] != 8:
                raise UnsupportedHDF5("offset/length sizes other than 8 bytes")
            entry = 56 if version == 0 else 60
            return struct.unpack_from("<Q", mm, entry + 8)[0]
        raise UnsupportedHDF5(f"superblock version {version}")

    def _messages(self, addr: int) -> List[Tuple[int, int, int]]:
        """(type, data offset, size) of each message of a v1 object header."""
        mm = self._mm
        if mm[addr] != 1:
            raise UnsupportedHDF5(f"object header version {mm[addr]} at {addr}")
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
                    out.append((mtype, p + 8, msize))
                p += 8 + msize
        return out

    def _node(self, addr: int, name: str):
        node = self._nodes.get(addr)
        if node is None:
            types = {m[0] for m in self._messages(addr)}
            node = (Group(self, addr, name) if _MSG_SYMBOL_TABLE in types
                    else Dataset(self, addr, name))
            self._nodes[addr] = node
        return node

    def _symbol_table(self, addr: int, name: str) -> Dict[str, int]:
        mm = self._mm
        stab = [p for t, p, _ in self._messages(addr) if t == _MSG_SYMBOL_TABLE]
        if not stab:
            raise UnsupportedHDF5(f"{name}: group without a symbol table")
        btree, heap = struct.unpack_from("<QQ", mm, stab[0])
        if mm[heap:heap + 4] != b"HEAP":
            raise OSError(f"{name}: bad local heap at {heap}")
        heap_data, = struct.unpack_from("<Q", mm, heap + 24)
        links: Dict[str, int] = {}
        for snod in self._btree_leaves(btree):
            if mm[snod:snod + 4] != b"SNOD":
                raise OSError(f"{name}: bad symbol-table node at {snod}")
            nsyms, = struct.unpack_from("<H", mm, snod + 6)
            for i in range(nsyms):
                off, obj = struct.unpack_from("<QQ", mm, snod + 8 + 40 * i)
                start = heap_data + off
                link = mm[start:mm.find(b"\0", start)].decode()
                links[link] = obj
        return links

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

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._fh.close()
            self._mm = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _read_dataspace(mm, p: int, name: str) -> Tuple[int, ...]:
    version, rank = mm[p], mm[p + 1]
    if version == 1:
        dims = p + 8
    elif version == 2:
        if mm[p + 3] == 2:  # null dataspace
            return (0,)
        dims = p + 4
    else:
        raise UnsupportedHDF5(f"{name}: dataspace version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", mm, dims)) if rank else ()


def _read_datatype(mm, p: int, name: str) -> np.dtype:
    cls, bits = mm[p] & 0x0F, mm[p + 1]
    size, = struct.unpack_from("<I", mm, p + 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 1 and size in (4, 8):
        return np.dtype(f"{order}f{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    raise UnsupportedHDF5(f"{name}: datatype class {cls} (size {size})")


def _read_layout(mm, p: int, name: str) -> Tuple[str, int, int]:
    version, cls = mm[p], mm[p + 1]
    if version != 3:
        raise UnsupportedHDF5(f"{name}: layout message version {version}")
    if cls == 0:
        size, = struct.unpack_from("<H", mm, p + 2)
        return "compact", p + 4, size
    if cls == 1:
        addr, size = struct.unpack_from("<QQ", mm, p + 2)
        return "contiguous", addr, size
    raise UnsupportedHDF5(f"{name}: chunked or virtual dataset layout")


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
