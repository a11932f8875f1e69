"""HDF5's filter pipeline, for io.hdf5's reader of chunked datasets.

The pipeline message (0x000B, versions 1 and 2) lists the filters a chunk
went through when it was written; reading undoes them in reverse order,
skipping those the chunk's filter mask marks as not applied. Four filters
are read: deflate (zlib), shuffle (a byte transpose), fletcher32 (a
checksum, verified) and lzf (h5py's own filter, ``compression="lzf"``,
which h5py reads without a plugin). Any other raises
:class:`UnsupportedHDF5` naming it.
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from helen_tpu_torch.io._hdf5_v2 import UnsupportedHDF5

DEFLATE, SHUFFLE, FLETCHER32, LZF = 1, 2, 3, 32000
# names of the registered filters libhdf5 and h5py know, for the refusal
NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
         6: "scaleoffset", 307: "bzip2", 32000: "lzf", 32001: "blosc", 32004: "lz4",
         32008: "bitshuffle", 32015: "zstd", 32017: "sz", 32026: "blosc2"}

Filter = Tuple[int, Tuple[int, ...]]  # (filter id, client data)


def parse_pipeline(mm, p: int, where: str) -> List[Filter]:
    """The filters of a pipeline message, in the order they were applied."""
    version, count = mm[p], mm[p + 1]
    if version not in (1, 2):
        raise UnsupportedHDF5(f"{where}: filter pipeline message version {version}")
    q = p + (8 if version == 1 else 2)
    out: List[Filter] = []
    for _ in range(count):
        fid, = struct.unpack_from("<H", mm, q)
        if version == 1 or fid >= 256:
            name_len, flags, nvalues = struct.unpack_from("<HHH", mm, q + 2)
            q += 8
        else:  # version 2 has no name length for the built-in filters
            name_len = 0
            flags, nvalues = struct.unpack_from("<HH", mm, q + 2)
            q += 6
        name = bytes(mm[q:q + name_len]).split(b"\0")[0].decode("ascii", "replace")
        q += name_len + (-name_len % 8 if version == 1 else 0)
        values = struct.unpack_from(f"<{nvalues}I", mm, q)
        q += 4 * nvalues + (4 if version == 1 and nvalues % 2 else 0)
        if fid not in (DEFLATE, SHUFFLE, FLETCHER32, LZF):
            label = name or NAMES.get(fid, "unregistered")
            raise UnsupportedHDF5(f"{where}: filter {fid} ({label})")
        out.append((fid, values))
    return out


def fletcher32(data) -> int:
    """libhdf5's Fletcher-32 (H5_checksum_fletcher32): sums of the 16-bit
    big-endian words of ``data`` (an odd last byte is the high byte of a
    last word), each folded mod 65535, where a non-zero sum that is a
    multiple of 65535 folds to 65535 and only the empty sum to 0."""
    n = len(data)
    words = np.frombuffer(data, dtype=">u2", count=n // 2)
    if n % 2:
        words = np.append(words, np.uint16(data[-1] << 8))
    count = len(words)
    # sum1 after word i is the prefix sum of the words, and sum2 adds those
    # prefixes: word i enters it (count - i) times. Exact sums, by blocks.
    s1 = s2 = 0
    step = 1 << 20
    ramp = np.arange(min(step, count), dtype=np.uint64)
    for o in range(0, count, step):
        w = words[o:o + step].astype(np.uint64)
        total = int(w.sum())
        s1 += total
        s2 += (count - o) * total - int((w * ramp[:len(w)]).sum())
    if s1 == 0:
        return 0
    return ((s2 % 65535 or 65535) << 16) | (s1 % 65535 or 65535)


def unshuffle(data: bytes, size: int) -> bytes:
    """Undo HDF5's shuffle: the bytes of ``size``-byte elements were stored
    as ``size`` planes (the trailing bytes of a partial element as they were)."""
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    planes = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(size, n)
    return planes.T.tobytes() + data[n * size:]


def unlzf(data, where: str) -> bytes:
    """Undo liblzf's compression (h5py's lzf filter stores its raw stream,
    no header). A control byte below 32 starts a literal run of it + 1
    bytes; above, its top 3 bits are a back-reference's length - 2 (7: one
    more byte adds to it) and its low 5 bits with the next byte the
    distance - 1 to copy from, which may overlap what it writes."""
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        ctrl = data[ip]
        ip += 1
        if ctrl < 32:
            if ip + ctrl + 1 > n:
                raise OSError(f"{where}: lzf literal run past the end of the chunk")
            out += data[ip:ip + ctrl + 1]
            ip += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            if ip >= n:
                raise OSError(f"{where}: lzf back-reference cut short")
            length += data[ip]
            ip += 1
        if ip >= n:
            raise OSError(f"{where}: lzf back-reference cut short")
        ref = len(out) - ((ctrl & 0x1F) << 8) - data[ip] - 1
        ip += 1
        if ref < 0:
            raise OSError(f"{where}: lzf back-reference before the start of the chunk")
        length += 2
        dist = len(out) - ref
        if dist >= length:
            out += out[ref:ref + length]
        else:  # the copy reads what it writes: a period of dist bytes
            out += (out[ref:] * (length // dist + 1))[:length]
    return bytes(out)


def decode(pipeline: List[Filter], data: bytes, mask: int, where: str) -> bytes:
    """Undo the filters ``pipeline`` applied to ``data`` (not those whose
    bit is set in ``mask``), last first."""
    for i in range(len(pipeline) - 1, -1, -1):
        if mask >> i & 1:
            continue
        fid, values = pipeline[i]
        if fid == DEFLATE:
            try:
                data = zlib.decompress(data)
            except zlib.error as exc:
                raise OSError(f"{where}: deflate failed ({exc})") from exc
        elif fid == SHUFFLE:
            data = unshuffle(data, values[0] if values else 1)
        elif fid == LZF:
            data = unlzf(data, where)
        else:
            if len(data) < 4:
                raise OSError(f"{where}: fletcher32 chunk shorter than its checksum")
            body, stored = data[:-4], data[-4:]
            want = fletcher32(body)
            # libhdf5 also takes the sum versions before 1.6.3 wrote on
            # little-endian hosts: the bytes of each 16-bit half swapped
            swapped = (want & 0x00FF00FF) << 8 | (want >> 8) & 0x00FF00FF
            if struct.unpack("<I", stored)[0] not in (want, swapped):
                raise OSError(f"{where}: fletcher32 checksum mismatch (data corrupted)")
            data = body
    return data
