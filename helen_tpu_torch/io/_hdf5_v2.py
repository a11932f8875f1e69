"""HDF5's newer metadata structures, for io.hdf5's reader.

Files written with ``libver="latest"`` or by a newer libhdf5 use these
(HDF5 file format specification, version 3): the superblock versions 2 and
3, version-2 object headers (``OHDR`` with ``OCHK`` continuation blocks),
new-style groups (link messages in the header, or a link-info message whose
fractal heap ``FRHP`` holds the link messages and whose version-2 B-tree
``BTHD`` indexes their names), and the version-2 B-trees that index a
dataset's chunks. Each of these carries a Jenkins lookup3 checksum, verified
here: a mismatch raises ``OSError`` naming the file.

Heap objects: only managed objects are read. Tiny and huge objects raise
:class:`UnsupportedHDF5`; a link message is stored as a huge object only
when it is longer than the heap's largest managed object (4 KiB in files
libhdf5 writes, so a link name of about that length), and never as a tiny
one. Filtered (compressed) fractal heaps raise too; libhdf5 never filters a
group's heap.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

UNDEF = 0xFFFFFFFFFFFFFFFF
_M = 0xFFFFFFFF


class UnsupportedHDF5(ValueError):
    """The file uses an HDF5 feature outside io.hdf5's subset."""


# ---------------------------------------------------------------------------
# checksums
# ---------------------------------------------------------------------------

def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, libhdf5's metadata checksum
    (H5_checksum_lookup3); the mixing rounds written out, rotations inline."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    if n == 0:
        return c
    tail = n - 12 * ((n - 1) // 12)  # the last block, 1-12 bytes
    body = n - tail
    words = struct.unpack_from(f"<{body // 4}I", data) if body else ()
    M = _M
    for i in range(0, len(words), 3):
        a = (a + words[i]) & M
        b = (b + words[i + 1]) & M
        c = (c + words[i + 2]) & M
        a = ((a - c) ^ (c << 4 | c >> 28)) & M
        c = (c + b) & M
        b = ((b - a) ^ (a << 6 | a >> 26)) & M
        a = (a + c) & M
        c = ((c - b) ^ (b << 8 | b >> 24)) & M
        b = (b + a) & M
        a = ((a - c) ^ (c << 16 | c >> 16)) & M
        c = (c + b) & M
        b = ((b - a) ^ (a << 19 | a >> 13)) & M
        a = (a + c) & M
        c = ((c - b) ^ (b << 4 | b >> 28)) & M
        b = (b + a) & M
    x, y, z = struct.unpack("<3I", bytes(data[body:]) + bytes(12 - tail))
    a = (a + x) & M
    b = (b + y) & M
    c = (c + z) & M
    c ^= b; c = (c - _rot(b, 14)) & M
    a ^= c; a = (a - _rot(c, 11)) & M
    b ^= a; b = (b - _rot(a, 25)) & M
    c ^= b; c = (c - _rot(b, 16)) & M
    a ^= c; a = (a - _rot(c, 4)) & M
    b ^= a; b = (b - _rot(a, 14)) & M
    c ^= b; c = (c - _rot(b, 24)) & M
    return c


def verify(f, start: int, end: int, what: str) -> None:
    """Check the lookup3 checksum stored at ``end`` over ``[start, end)``."""
    stored, = struct.unpack_from("<I", f._mm, end)
    if lookup3(f._mm[start:end]) != stored:
        raise OSError(f"{f.filename}: {what} at {start}: checksum mismatch")


def _signature(f, addr: int, sig: bytes, what: str) -> None:
    if f._mm[addr:addr + 4] != sig:
        raise OSError(f"{f.filename}: bad {what} at {addr} (no {sig.decode()} signature)")


def uint(mm, p: int, width: int) -> int:
    """A little-endian unsigned integer of ``width`` bytes."""
    return int.from_bytes(mm[p:p + width], "little")


def _log2(x: int) -> int:
    return x.bit_length() - 1


def limit_enc_size(x: int) -> int:
    """Bytes libhdf5 uses to encode counts up to ``x`` (H5VM_limit_enc_size)."""
    return _log2(x) // 8 + 1


# ---------------------------------------------------------------------------
# superblock and object headers
# ---------------------------------------------------------------------------

def superblock_root(f) -> int:
    """The root group's object header address of a version-2/3 superblock."""
    verify(f, 0, 44, "superblock")
    return struct.unpack_from("<Q", f._mm, 36)[0]


def ohdr_messages(f, addr: int, continuation: int) -> List[Tuple[int, int, int, int]]:
    """(type, data offset, size, flags) of each message of a version-2
    object header, continuation blocks followed; checksums verified."""
    mm = f._mm
    if mm[addr + 4] != 2:
        raise UnsupportedHDF5(f"object header version {mm[addr + 4]} at {addr}")
    flags = mm[addr + 5]
    p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 0x03)
    start = p + width
    end = start + uint(mm, p, width)
    verify(f, addr, end, "object header")
    head = 6 if flags & 0x04 else 4  # type, size, flags [, creation order]
    blocks = [(start, end)]
    out: List[Tuple[int, int, int, int]] = []
    while blocks:
        p, end = blocks.pop(0)
        while p + head <= end:  # a shorter remainder is a gap
            mtype, msize, mflags = mm[p], struct.unpack_from("<H", mm, p + 1)[0], mm[p + 3]
            body = p + head
            if mtype == continuation:
                cont, length = struct.unpack_from("<QQ", mm, body)
                _signature(f, cont, b"OCHK", "object header continuation block")
                verify(f, cont, cont + length - 4, "object header continuation block")
                blocks.append((cont + 4, cont + length - 4))
            elif mtype:  # 0 is a NIL (padding) message
                out.append((mtype, body, msize, mflags))
            p = body + msize
    return out


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

class SoftLink(str):
    """A soft link's target path (absolute, or relative to the group that
    holds the link), followed on access as libhdf5 follows it."""


Link = Union[int, SoftLink, str]  # a hard link's object header address, a
                                  # soft link, or what another kind of link
                                  # points at (refused on access)


def parse_link(mm, p: int) -> Tuple[str, Link]:
    """(name, target) of a link message (0x0006)."""
    version, flags = mm[p], mm[p + 1]
    if version != 1:
        raise UnsupportedHDF5(f"link message version {version}")
    q = p + 2
    ltype = 0
    if flags & 0x08:
        ltype = mm[q]
        q += 1
    if flags & 0x04:
        q += 8  # creation order
    if flags & 0x10:
        q += 1  # character set of the name
    width = 1 << (flags & 0x03)
    nlen = uint(mm, q, width)
    q += width
    name = bytes(mm[q:q + nlen]).decode("utf-8")
    q += nlen
    if ltype == 0:
        return name, struct.unpack_from("<Q", mm, q)[0]
    if ltype == 1:
        size, = struct.unpack_from("<H", mm, q)
        return name, SoftLink(bytes(mm[q + 2:q + 2 + size]).decode("utf-8"))
    if ltype == 64:
        size, = struct.unpack_from("<H", mm, q)
        parts = bytes(mm[q + 3:q + 2 + size]).split(b"\0")
        return name, (f"an external link to {parts[1].decode('utf-8', 'replace')!r} "
                      f"in {parts[0].decode('utf-8', 'replace')!r}")
    return name, f"a link of type {ltype}"


def dense_links(f, link_info: int) -> Dict[str, Link]:
    """The links of a group in dense storage: the records of the link-info
    message's name index, each a heap ID of a link message in its fractal
    heap. ``{}`` when the group keeps its links in its header."""
    mm = f._mm
    version, flags = mm[link_info], mm[link_info + 1]
    if version != 0:
        raise UnsupportedHDF5(f"link info message version {version}")
    q = link_info + 2 + (8 if flags & 0x01 else 0)
    heap_addr, name_index = struct.unpack_from("<QQ", mm, q)
    if heap_addr == UNDEF:
        return {}
    heap = FractalHeap(f, heap_addr)
    links: Dict[str, Link] = {}
    for rec in btree2_records(f, name_index, 5):  # (name hash, heap ID)
        name, target = parse_link(heap.read(rec[4:]), 0)
        links[name] = target
    return links


# ---------------------------------------------------------------------------
# fractal heap
# ---------------------------------------------------------------------------

class FractalHeap:
    """Reader of a fractal heap's managed objects (its doubling table of
    direct and indirect blocks)."""

    def __init__(self, f, addr: int):
        mm = f._mm
        _signature(f, addr, b"FRHP", "fractal heap header")
        if mm[addr + 4] != 0:
            raise UnsupportedHDF5(f"fractal heap version {mm[addr + 4]}")
        self.f = f
        self.id_len, filter_len = struct.unpack_from("<HH", mm, addr + 5)
        flags = mm[addr + 9]
        max_managed, = struct.unpack_from("<I", mm, addr + 10)
        (self.width, self.start, max_direct, max_bits, _,
         self.root, self.rows) = struct.unpack_from("<HQQHHQH", mm, addr + 110)
        if filter_len:
            raise UnsupportedHDF5("a filtered fractal heap")
        verify(f, addr, addr + 142, "fractal heap header")
        self.checked_dblocks = bool(flags & 0x02)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8, limit_enc_size(max_managed))
        self.first_row_bits = _log2(self.start) + _log2(self.width)
        self.max_direct_rows = _log2(max_direct) - _log2(self.start) + 2
        self.row_size = [self.start] + [self.start << r for r in range(max_bits)]
        self._verified = set()

    def _row_col(self, off: int) -> Tuple[int, int]:
        """(row, column) of the block holding offset ``off`` of a block's
        span (H5HF__dtable_lookup)."""
        if off < self.start * self.width:
            return 0, off // self.start
        high = _log2(off)
        row = high - self.first_row_bits + 1
        return row, (off - (1 << high)) // self.row_size[row]

    def _check(self, addr: int, end: int, what: str, zero_at: int = None) -> None:
        if addr in self._verified:
            return
        mm = self.f._mm
        if zero_at is None:
            verify(self.f, addr, end, what)
        else:  # a direct block's checksum covers the block with itself zeroed
            block = bytearray(mm[addr:end])
            stored, = struct.unpack_from("<I", block, zero_at - addr)
            block[zero_at - addr:zero_at - addr + 4] = bytes(4)
            if lookup3(block) != stored:
                raise OSError(f"{self.f.filename}: {what} at {addr}: checksum mismatch")
        self._verified.add(addr)

    def read(self, heap_id: bytes) -> bytes:
        """The bytes of the managed object ``heap_id`` names."""
        kind = (heap_id[0] >> 4) & 0x03
        if kind != 0:
            raise UnsupportedHDF5(f"{'huge' if kind == 1 else 'tiny'} fractal heap objects")
        off = int.from_bytes(heap_id[1:1 + self.off_size], "little")
        length = int.from_bytes(heap_id[1 + self.off_size:1 + self.off_size + self.len_size],
                                "little")
        mm, head = self.f._mm, 5 + 8 + self.off_size  # signature, version, heap, offset
        block, size, base = self.root, self.start, 0
        if self.rows:  # the root is an indirect block: descend to a direct one
            rows = self.rows
            while True:
                _signature(self.f, block, b"FHIB", "fractal heap indirect block")
                entries = block + head
                self._check(block, entries + 8 * rows * self.width,
                            "fractal heap indirect block")
                row, col = self._row_col(off - base)
                child, = struct.unpack_from("<Q", mm, entries + 8 * (row * self.width + col))
                if child == UNDEF:
                    raise OSError(f"{self.f.filename}: heap object at {off} in a missing block")
                if row < self.max_direct_rows:
                    block, size = child, self.row_size[row]
                    break
                block = child
                base = uint(mm, child + 13, self.off_size)
                rows = _log2(self.row_size[row]) - self.first_row_bits + 1
        _signature(self.f, block, b"FHDB", "fractal heap direct block")
        if self.checked_dblocks:
            self._check(block, block + size, "fractal heap direct block", block + head)
        start = block + off - uint(mm, block + 13, self.off_size)
        return mm[start:start + length]


# ---------------------------------------------------------------------------
# version-2 B-trees
# ---------------------------------------------------------------------------

def btree2_records(f, addr: int, rtype: int) -> Iterator[bytes]:
    """Every record of the version-2 B-tree at ``addr`` (record type
    ``rtype``), in no particular order; checksums verified."""
    mm = f._mm
    _signature(f, addr, b"BTHD", "version-2 B-tree header")
    if mm[addr + 5] != rtype:
        raise OSError(f"{f.filename}: B-tree at {addr} holds records of type "
                      f"{mm[addr + 5]}, not {rtype}")
    node_size, = struct.unpack_from("<I", mm, addr + 6)
    rec_size, depth = struct.unpack_from("<HH", mm, addr + 10)
    root, = struct.unpack_from("<Q", mm, addr + 16)
    root_n, = struct.unpack_from("<H", mm, addr + 24)
    verify(f, addr, addr + 34, "version-2 B-tree header")
    if root == UNDEF:
        return
    # the widths of an internal node's child pointers (H5B2__hdr_init)
    leaf_max = (node_size - 10) // rec_size
    nrec_size = limit_enc_size(leaf_max)
    cum, cum_size = [leaf_max], [0]
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        most = (node_size - 10 - ptr) // (rec_size + ptr)
        cum.append((most + 1) * cum[d - 1] + most)
        cum_size.append(limit_enc_size(cum[-1]))
    stack = [(root, root_n, depth)]
    while stack:
        node, n, d = stack.pop()
        recs = node + 6
        if d == 0:
            _signature(f, node, b"BTLF", "version-2 B-tree leaf")
            verify(f, node, recs + n * rec_size, "version-2 B-tree leaf")
        else:
            _signature(f, node, b"BTIN", "version-2 B-tree internal node")
            p = recs + n * rec_size
            total = cum_size[d - 1] if d > 1 else 0
            for _ in range(n + 1):
                child, = struct.unpack_from("<Q", mm, p)
                stack.append((child, uint(mm, p + 8, nrec_size), d - 1))
                p += 8 + nrec_size + total
            verify(f, node, p, "version-2 B-tree internal node")
        for i in range(n):
            yield mm[recs + i * rec_size:recs + (i + 1) * rec_size]
