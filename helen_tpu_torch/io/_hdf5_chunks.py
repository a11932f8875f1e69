"""Chunked datasets, for io.hdf5's reader.

A chunked dataset stores its array as equal chunks, each possibly filtered
(io._hdf5_filters), found through an index. The layout message (0x0008)
names the index: version 3 always a version-1 B-tree (node type 1); version
4 one of single chunk (1), implicit (2), fixed array (3), extensible array
(4) or version-2 B-tree (5, record types 10 and 11). Edge chunks are stored
at full size and trimmed on read; a chunk never written reads as the fill
value.

A read of rows touches only the chunks those rows lie in, and each once.
Unfiltered chunks are sliced out of the file's memory map; filtered ones
are decoded, and a row read keeps the latest of them in a small cache (at
most :data:`CACHE_BYTES` per dataset, locked for the loader's threads), so
consecutive batches that share a chunk decode it once. A whole read
(``dset[()]``) caches nothing.
"""
from __future__ import annotations

import itertools
import struct
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from helen_tpu_torch.io._hdf5_filters import decode
from helen_tpu_torch.io._hdf5_v2 import UNDEF, UnsupportedHDF5, btree2_records, uint, verify

CACHE_BYTES = 64 << 20
Entry = Tuple[int, int, int]  # (address, stored size, filter mask)
_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
            5: "version-2 B-tree"}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _down(counts) -> Tuple[int, ...]:
    """Row-major strides of a grid of ``counts`` (the first count unused)."""
    out, acc = [], 1
    for n in reversed(counts):
        out.append(acc)
        acc *= n if n is not None else 1
    return tuple(reversed(out))


class Chunked:
    """The storage of one chunked dataset: its index and its reads."""

    def __init__(self, f, name: str, p: int, shape, maxshape, dtype: np.dtype,
                 pipeline, fill: Optional[bytes]):
        mm = f._mm
        self.f, self.name, self.shape, self.dtype = f, name, tuple(shape), dtype
        self.pipeline = pipeline
        self.fill = fill
        rank = len(self.shape)
        version = mm[p]
        self.partial_raw = False  # edge chunks stored unfiltered
        self.filtered_single: Optional[Tuple[int, int]] = None
        if version == 3:
            ndims = mm[p + 2]
            self.addr, = struct.unpack_from("<Q", mm, p + 3)
            dims = struct.unpack_from(f"<{ndims}I", mm, p + 11)
            self.index = 0  # a version-1 B-tree
        else:
            flags, ndims, width = mm[p + 2], mm[p + 3], mm[p + 4]
            q = p + 5
            dims = [uint(mm, q + i * width, width) for i in range(ndims)]
            q += ndims * width
            self.index = mm[q]
            q += 1
            self.partial_raw = bool(flags & 0x01)
            if self.index == 1 and flags & 0x02:
                self.filtered_single = struct.unpack_from("<QI", mm, q)
                q += 12
            elif self.index == 3:
                q += 1  # page bits, also in the array's header
            elif self.index == 4:
                q += 5
            elif self.index == 5:
                q += 6
            elif self.index != 1 and self.index != 2:
                raise UnsupportedHDF5(f"{name}: chunk index type {self.index}")
            self.addr, = struct.unpack_from("<Q", mm, q)
        if len(dims) != rank + 1 or dims[-1] != dtype.itemsize:
            raise UnsupportedHDF5(f"{name}: chunk dimensions {tuple(dims)} for shape "
                                  f"{self.shape} of {dtype}")
        self.chunk = tuple(int(d) for d in dims[:-1])
        self.count = int(np.prod(self.chunk, dtype=np.int64))
        self.nbytes = self.count * dtype.itemsize
        self.grid = tuple(_ceil(s, c) for s, c in zip(self.shape, self.chunk))
        self.maxgrid = tuple(None if m is None else _ceil(m, c)
                             for m, c in zip(maxshape, self.chunk))
        self._map: Optional[Dict[Tuple[int, ...], Entry]] = None
        self._fill_chunk: Optional[np.ndarray] = None
        self._cache: "OrderedDict[Tuple[int, ...], np.ndarray]" = OrderedDict()
        self._cache_bytes = 0
        self._lock = threading.Lock()

    @property
    def where(self) -> str:
        return f"{self.f.filename}: {self.name}"

    # -- the index ---------------------------------------------------------

    def _index(self) -> Dict[Tuple[int, ...], Entry]:
        if self._map is None:
            chunks: Dict[Tuple[int, ...], Entry] = {}
            if self.addr != UNDEF:
                if self.index == 0:
                    self._btree1(self.addr, chunks)
                elif self.index == 1:
                    size, mask = self.filtered_single or (self.nbytes, 0)
                    chunks[(0,) * len(self.shape)] = (self.addr, size, mask)
                elif self.index == 2:
                    down = _down(self.maxgrid)
                    for c in itertools.product(*map(range, self.grid)):
                        k = sum(i * d for i, d in zip(c, down))
                        chunks[c] = (self.addr + k * self.nbytes, self.nbytes, 0)
                elif self.index == 3:
                    self._fixed_array(chunks)
                elif self.index == 4:
                    self._extensible_array(chunks)
                else:
                    self._btree2(chunks)
            self._map = chunks
        return self._map

    def _entry(self, raw: bytes, filtered: bool) -> Optional[Entry]:
        addr = int.from_bytes(raw[:8], "little")
        if addr == UNDEF:
            return None
        if not filtered:
            return addr, self.nbytes, 0
        return (addr, int.from_bytes(raw[8:-4], "little"),
                int.from_bytes(raw[-4:], "little"))

    def _btree1(self, addr: int, out) -> None:
        mm, rank = self.f._mm, len(self.shape)
        if mm[addr:addr + 4] != b"TREE" or mm[addr + 4] != 1:
            raise OSError(f"{self.where}: bad chunk B-tree node at {addr}")
        level = mm[addr + 5]
        used, = struct.unpack_from("<H", mm, addr + 6)
        key = 8 + 8 * (rank + 1)
        p = addr + 24
        for _ in range(used):
            size, mask = struct.unpack_from("<II", mm, p)
            offsets = struct.unpack_from(f"<{rank}Q", mm, p + 8)
            child, = struct.unpack_from("<Q", mm, p + key)
            if level:
                self._btree1(child, out)
            else:
                out[tuple(o // c for o, c in zip(offsets, self.chunk))] = (child, size, mask)
            p += key + 8

    def _linear(self, out, entries) -> None:
        """Place the entries of an array index (fixed array), numbered
        row-major over the grid of the dataset's largest shape."""
        down = _down(self.maxgrid)
        for k, entry in entries:
            c, r = [], k
            for d in down:
                c.append(r // d)
                r %= d
            c = tuple(c)
            if all(i < n for i, n in zip(c, self.grid)):
                out[c] = entry

    def _fixed_array(self, out) -> None:
        f, mm = self.f, self.f._mm
        h = self.addr
        if mm[h:h + 4] != b"FAHD":
            raise OSError(f"{self.where}: bad fixed array header at {h}")
        verify(f, h, h + 24, "fixed array header")
        filtered, esize, page_bits = mm[h + 5] == 1, mm[h + 6], mm[h + 7]
        n, dblk = struct.unpack_from("<QQ", mm, h + 8)
        if dblk == UNDEF:
            return
        if mm[dblk:dblk + 4] != b"FADB":
            raise OSError(f"{self.where}: bad fixed array data block at {dblk}")
        page = 1 << page_bits
        entries = []
        if n <= page:
            start = dblk + 14
            verify(f, dblk, start + n * esize, "fixed array data block")
            pages = [(0, start, n)]
        else:  # paged: a bitmap of the pages written, then the pages
            npages = _ceil(n, page)
            bitmap = dblk + 14
            verify(f, dblk, bitmap + (npages + 7) // 8, "fixed array data block")
            first = bitmap + (npages + 7) // 8 + 4
            pages = []
            for i in range(npages):
                if mm[bitmap + i // 8] & (0x80 >> i % 8):
                    cnt = min(page, n - i * page)
                    at = first + i * (page * esize + 4)
                    verify(f, at, at + cnt * esize, "fixed array data block page")
                    pages.append((i * page, at, cnt))
        for k0, at, cnt in pages:
            raw = mm[at:at + cnt * esize]
            for j in range(cnt):
                e = self._entry(raw[j * esize:(j + 1) * esize], filtered)
                if e is not None:
                    entries.append((k0 + j, e))
        self._linear(out, entries)

    def _extensible_array(self, out) -> None:
        ea = _ExtensibleArray(self.f, self.addr, self.where)
        unlim = [i for i, m in enumerate(self.maxgrid) if m is None]
        if len(unlim) != 1:
            raise OSError(f"{self.where}: an extensible array index needs one unlimited axis")
        u = unlim[0]
        order = [u] + [i for i in range(len(self.grid)) if i != u]
        down = _down([self.maxgrid[i] for i in order])
        for c in itertools.product(*map(range, self.grid)):
            raw = ea.get(sum(c[i] * d for i, d in zip(order, down)))
            e = None if raw is None else self._entry(raw, ea.filtered)
            if e is not None:
                out[c] = e

    def _btree2(self, out) -> None:
        rank = len(self.shape)
        filtered = bool(self.pipeline)
        for rec in btree2_records(self.f, self.addr, 11 if filtered else 10):
            c = struct.unpack_from(f"<{rank}Q", rec, len(rec) - 8 * rank)
            e = self._entry(rec[:len(rec) - 8 * rank], filtered)
            if e is not None:
                out[tuple(c)] = e

    # -- chunks ------------------------------------------------------------

    def _chunk(self, c: Tuple[int, ...], cache: bool) -> np.ndarray:
        """Chunk ``c`` at full chunk shape: a view of the map (unfiltered),
        decoded (filtered), or the fill value (never written)."""
        entry = self._index().get(c)
        if entry is None:
            if self._fill_chunk is None:
                value = (np.frombuffer(self.fill, self.dtype, 1)[0] if self.fill
                         else np.zeros((), self.dtype))
                self._fill_chunk = np.full(self.chunk, value, self.dtype)
            return self._fill_chunk
        addr, size, mask = entry
        raw = not self.pipeline or (self.partial_raw and any(
            (i + 1) * n > s for i, n, s in zip(c, self.chunk, self.shape)))
        if raw:
            if addr + self.nbytes > len(self.f._mm):
                raise OSError(f"{self.where}: chunk at {addr} past the end of the file")
            return np.frombuffer(self.f._mm, self.dtype, self.count, addr).reshape(self.chunk)
        if cache:
            with self._lock:
                hit = self._cache.get(c)
                if hit is not None:
                    self._cache.move_to_end(c)
                    return hit
        data = decode(self.pipeline, self.f._mm[addr:addr + size], mask,
                      f"{self.where}: chunk {c} at {addr}")
        if len(data) < self.nbytes:
            raise OSError(f"{self.where}: chunk {c} at {addr} decodes to {len(data)} "
                          f"bytes, not {self.nbytes}")
        arr = np.frombuffer(data, self.dtype, self.count).reshape(self.chunk)
        if cache:
            with self._lock:
                if c not in self._cache:
                    self._cache[c] = arr
                    self._cache_bytes += arr.nbytes
                while self._cache_bytes > CACHE_BYTES and len(self._cache) > 1:
                    self._cache_bytes -= self._cache.popitem(last=False)[1].nbytes
        return arr

    def read(self, key) -> np.ndarray:
        """``key`` None (the whole dataset), a row slice, or an array of
        row indices; decodes each chunk the rows touch once."""
        shape, chunk = self.shape, self.chunk
        n0, c0 = shape[0], chunk[0]
        # each chunk column across the other axes: (chunk coordinates, its
        # place in the dataset, the part of the chunk inside the dataset)
        cols = list(itertools.product(*[
            [(k, slice(k * c, min(k * c + c, s)), slice(0, min(c, s - k * c)))
             for k in range(g)] for s, c, g in zip(shape[1:], chunk[1:], self.grid[1:])]))
        cache = key is not None
        if key is None or isinstance(key, slice):
            lo, hi = (0, n0) if key is None else key.indices(n0)[:2]
            hi = max(lo, hi)
            out = np.empty((hi - lo,) + shape[1:], self.dtype)
            for r in range(lo // c0, _ceil(hi, c0)):
                a, b = max(lo, r * c0), min(hi, r * c0 + c0)
                for col in cols:
                    arr = self._chunk((r,) + tuple(k for k, _, _ in col), cache)
                    out[(slice(a - lo, b - lo),) + tuple(s for _, s, _ in col)] = \
                        arr[(slice(a - r * c0, b - r * c0),) + tuple(t for _, _, t in col)]
            return out
        idx = np.asarray(key, dtype=np.int64)
        idx = np.where(idx < 0, idx + n0, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n0):
            raise IndexError(f"{self.name}: row index out of range for {n0} rows")
        out = np.empty((len(idx),) + shape[1:], self.dtype)
        rows = idx // c0
        order = np.argsort(rows, kind="stable")
        for sel in np.split(order, np.flatnonzero(np.diff(rows[order])) + 1):
            if not len(sel):
                continue
            r = int(rows[sel[0]])
            local = idx[sel] - r * c0
            for col in cols:
                arr = self._chunk((r,) + tuple(k for k, _, _ in col), cache)
                out[(sel,) + tuple(s for _, s, _ in col)] = \
                    arr[(local,) + tuple(t for _, _, t in col)]
        return out


class _ExtensibleArray:
    """Element lookup in an extensible array (H5EA__lookup_elmt): the
    index block's own elements, its data blocks, then super blocks of data
    blocks, paged where a data block exceeds a page."""

    def __init__(self, f, addr: int, where: str):
        mm = f._mm
        if mm[addr:addr + 4] != b"EAHD":
            raise OSError(f"{where}: bad extensible array header at {addr}")
        verify(f, addr, addr + 68, "extensible array header")
        self.f, self.where = f, where
        self.filtered = mm[addr + 5] == 1
        (self.esize, bits, self.idx_elmts, self.dblk_min, sblk_min_ptrs,
         page_bits) = mm[addr + 6:addr + 12]
        self.iblock, = struct.unpack_from("<Q", mm, addr + 60)
        self.off_size = (bits + 7) // 8
        self.page = 1 << page_bits
        nsblks = 1 + bits - (self.dblk_min.bit_length() - 1)
        self.sblk = []  # (data blocks, elements per data block, first element, first block)
        start = first = 0
        for u in range(nsblks):
            nd, ne = 1 << (u // 2), (1 << ((u + 1) // 2)) * self.dblk_min
            self.sblk.append((nd, ne, start, first))
            start += nd * ne
            first += nd
        self.ndblk_addrs = 2 * (sblk_min_ptrs - 1)
        self.iblock_sblks = 2 * (sblk_min_ptrs.bit_length() - 1)
        self.nsblk_addrs = nsblks - self.iblock_sblks
        if self.iblock != UNDEF:
            if mm[self.iblock:self.iblock + 4] != b"EAIB":
                raise OSError(f"{where}: bad extensible array index block at {self.iblock}")
            end = (self.iblock + 14 + self.idx_elmts * self.esize
                   + 8 * (self.ndblk_addrs + self.nsblk_addrs))
            verify(f, self.iblock, end, "extensible array index block")

    def _addr(self, at: int) -> int:
        return struct.unpack_from("<Q", self.f._mm, at)[0]

    def _element(self, dblk: int, nelmts: int, k: int, page_ok=None) -> Optional[bytes]:
        """Element ``k`` of the data block at ``dblk`` of ``nelmts`` elements."""
        mm, f = self.f._mm, self.f
        if mm[dblk:dblk + 4] != b"EADB":
            raise OSError(f"{self.where}: bad extensible array data block at {dblk}")
        head = dblk + 14 + self.off_size
        if nelmts <= self.page:
            verify(f, dblk, head + nelmts * self.esize, "extensible array data block")
            at = head + k * self.esize
        else:
            if page_ok is None:
                raise UnsupportedHDF5(f"{self.where}: paged data block of an index block")
            p = k // self.page
            if not page_ok(p):
                return None
            page_at = head + 4 + p * (self.page * self.esize + 4)
            verify(f, page_at, page_at + self.page * self.esize, "extensible array page")
            at = page_at + (k % self.page) * self.esize
        return mm[at:at + self.esize]

    def get(self, idx: int) -> Optional[bytes]:
        if self.iblock == UNDEF:
            return None
        mm = self.f._mm
        elmts = self.iblock + 14
        if idx < self.idx_elmts:
            return mm[elmts + idx * self.esize:elmts + (idx + 1) * self.esize]
        rel = idx - self.idx_elmts
        s = (rel // self.dblk_min + 1).bit_length() - 1
        nd, ne, start, first = self.sblk[s]
        k = rel - start
        dblks = elmts + self.idx_elmts * self.esize
        if s < self.iblock_sblks:
            dblk = self._addr(dblks + 8 * (first + k // ne))
            return None if dblk == UNDEF else self._element(dblk, ne, k % ne)
        sblk = self._addr(dblks + 8 * self.ndblk_addrs + 8 * (s - self.iblock_sblks))
        if sblk == UNDEF:
            return None
        if mm[sblk:sblk + 4] != b"EASB":
            raise OSError(f"{self.where}: bad extensible array super block at {sblk}")
        npages = ne // self.page if ne > self.page else 0
        bitmap = sblk + 14 + self.off_size
        addrs = bitmap + ((nd * npages + 7) // 8 if npages else 0)
        verify(self.f, sblk, addrs + 8 * nd, "extensible array super block")
        j = k // ne
        dblk = self._addr(addrs + 8 * j)
        if dblk == UNDEF:
            return None

        def page_ok(p: int) -> bool:
            bit = j * npages + p
            return bool(mm[bitmap + bit // 8] & (0x80 >> bit % 8))

        return self._element(dblk, ne, k % ne, page_ok)
