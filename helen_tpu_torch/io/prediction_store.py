"""Intermediate prediction HDF5 store.

Writes/reads the same on-disk schema as the reference DataStore
(reference DataStore.py:83-133) so stitch can merge predictions positionally:

  predictions/<contig>/<contig>-<start>-<end>/contig_start        int scalar
  predictions/<contig>/<contig>-<start>-<end>/contig_end          int scalar
  predictions/<contig>/<contig>-<start>-<end>/<chunk_id>/position uint32 (L, 3)
  predictions/<contig>/<contig>-<start>-<end>/<chunk_id>/bases    uint8  (L,)
  predictions/<contig>/<contig>-<start>-<end>/<chunk_id>/rles     uint8  (L,)

The ``<contig>-<start>-<end>`` prefix groups all image chunks of one
MarginPolish region.  Unlike the reference (in-memory dedupe sets that die
with the process), this store is resumable: ``has_chunk`` answers from the
keys already stored, so an interrupted consensus run skips them
(``PredictionStore`` mode "a"; its files and journal are described there).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from helen_tpu_torch.io import hdf5

PRED_ROOT = "predictions"
# records between two syncs of the write-behind thread: it puts the payloads
# on disk while the run goes on, so that a flush (one per ten batches of 512
# in call_consensus) finds little left to sync
WRITE_BEHIND_RECORDS = 512

# Per-thread read-handle cache. Stitch reads each prediction file once per
# REGION (thousands of times per contig), so files stay open. Handles are
# keyed on (mtime_ns, size) so a file rewritten by a later run is
# transparently reopened (the writer replaces the file atomically, so an open
# map keeps reading the old one). Thread-local => safe under the stitch
# process pool (fresh processes) and the in-process fallback alike.
_read_handles = threading.local()


def open_prediction_file(path: str) -> hdf5.File:
    """Return a cached read-only handle for ``path`` (per-thread)."""
    cache: Dict[str, Tuple[Tuple[int, int], hdf5.File]] = getattr(
        _read_handles, "files", None
    )
    if cache is None:
        cache = _read_handles.files = {}
    st = os.stat(path)
    stamp = (st.st_mtime_ns, st.st_size)
    entry = cache.get(path)
    if entry is not None:
        old_stamp, f = entry
        if old_stamp == stamp:
            return f
        f.close()
        groups = getattr(_read_handles, "groups", None)
        if groups:
            for key in [k for k in groups if k[0] == path]:
                del groups[key]
    f = hdf5.File(path)
    cache[path] = (stamp, f)
    return f


def _contig_group(path: str, contig: str) -> Optional[hdf5.Group]:
    """Cached ``f[predictions/<contig>]`` group for a cached handle (stitch
    looks it up once per region otherwise). Returns None when absent."""
    groups = getattr(_read_handles, "groups", None)
    if groups is None:
        groups = _read_handles.groups = {}
    f = open_prediction_file(path)  # evicts stale group entries on reopen
    key = (path, contig)
    if key not in groups:
        if PRED_ROOT in f and contig in f[PRED_ROOT]:
            groups[key] = f[PRED_ROOT][contig]
        else:
            groups[key] = None
    return groups[key]


def close_read_handles(path: str) -> None:
    """Drop this thread's cached read handle of ``path`` (a writer is about
    to change the file)."""
    cache = getattr(_read_handles, "files", None)
    entry = cache.pop(path, None) if cache else None
    if entry is not None:
        entry[1].close()
    groups = getattr(_read_handles, "groups", None)
    if groups:
        for key in [k for k in groups if k[0] == path]:
            del groups[key]


def _store_keys(f: hdf5.File) -> Set[Tuple[str, str]]:
    keys: Set[Tuple[str, str]] = set()
    if PRED_ROOT in f:
        root = f[PRED_ROOT]
        for contig in root.keys():
            cgrp = root[contig]
            for region in cgrp.keys():
                keys.update((region, k) for k in cgrp[region].keys()
                            if k not in ("contig_start", "contig_end"))
    return keys


def _chunk_keys(path: str) -> Set[Tuple[str, str]]:
    """(region, chunk) keys present in an existing prediction file (none if
    there is no file at ``path``)."""
    if not os.path.exists(path):
        return set()
    with hdf5.File(path) as f:
        return _store_keys(f)


def _journal(path: str) -> Iterator[Tuple[dict, int]]:
    """(entry, offset past it) of each whole line of a store's journal; a
    torn last line (a kill mid-write) ends it. Read as a stream: a genome's
    journal holds millions of records."""
    valid = 0
    with open(path, "rb") as f:
        for line in f:
            if not line.endswith(b"\n"):
                return
            try:
                entry = json.loads(line)
            except ValueError:
                return
            valid += len(line)
            yield entry, valid


def _entry_end(entry: dict) -> int:
    """The first byte past an entry's payloads."""
    if "r" in entry:
        return entry["r"][3] + 16
    _, _, _, rows, addrs = entry["c"]
    sizes = (12 * rows, rows, rows, rows)
    return max((a + n for a, n in zip(addrs, sizes) if a is not None and n), default=0)


def generation(path: str, k: int) -> str:
    """The ``k``-th file of the store named ``path``: ``path`` itself, then
    ``<root>.r<k><ext>``, the file each resumed run after it writes."""
    if k == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.r{k}{ext}"


def store_files(path: str) -> List[str]:
    """The files of the store named ``path`` that exist, complete or left
    partial by a killed run, in the order they were written."""
    out = []
    for k in itertools.count():
        p = generation(path, k)
        if not (os.path.exists(p) or os.path.exists(p + ".partial")):
            return out
        out.append(p)


class PredictionStore:
    """Writer for one prediction file (one file per inference shard).

    Writes go through the port's own HDF5 writer (io.hdf5); the on-disk
    schema is the reference's (module docstring), readable by h5py and by
    helen_tpu's stitch. A file is written as ``<name>.partial`` and appears
    at its name, complete, only when it closes; a complete file is never
    written again. Mode "w" starts the store afresh. Mode "a" continues
    it: ``has_chunk`` answers for every record in its files
    (:func:`store_files`); a file a killed run left partial is recovered and
    written on; else new records go to the next file of the store
    (:func:`generation`), made at the first of them, so a resumed run that
    adds nothing leaves the store as it was. Stitch reads every ``*.hdf``
    of a directory, so it merges them all.

    Crash behaviour: beside the payloads, ``<name>.journal`` gets one line
    per region and per record since the last :meth:`flush`, which syncs the
    payloads, then the journal. A run killed after a flush resumes (mode
    "a") from the journal: the group tree is rebuilt from it and the bytes
    past its last record are cut, so every record that flush covered is
    kept. A flush costs the records written since the last one, whatever
    the store's size, and less than that: a write-behind thread syncs the
    payloads every ``WRITE_BEHIND_RECORDS`` records while the run goes on,
    so the flush's own sync finds little left. Closing after an exception only flushes: the file
    stays resumable and is not published.
    """

    def __init__(self, filename: str, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        self.file: Optional[hdf5.Writer] = None
        self._journal = None
        self._pending: List[bytes] = []
        self._chunks: Set[Tuple[str, str]] = set()
        self._region_groups: Dict[str, hdf5.WGroup] = {}
        if mode == "w":
            for k in itertools.count():
                p = generation(filename, k)
                gone = [x for x in (p, p + ".partial", p + ".journal") if os.path.exists(x)]
                for x in gone:
                    os.unlink(x)
                if not gone and k:
                    break
            self._target(filename)
            self._create()
            return
        for k in itertools.count():
            path = generation(filename, k)
            partial = os.path.exists(path + ".partial")
            if partial and os.path.exists(path + ".journal"):
                self._target(path)
                self._recover()
                return
            if not os.path.exists(path):
                self._target(path)
                if partial:
                    os.unlink(self.partial)  # a kill before its journal began
                if k == 0:
                    # a store with no file yet: made now, as in mode "w", so
                    # even one that receives nothing exists for stitch
                    self._create()
                return
            if os.path.exists(path + ".journal"):
                os.unlink(path + ".journal")  # outlived its run's close
            self._chunks |= _chunk_keys(path)

    def _target(self, path: str) -> None:
        """The file this store writes."""
        self.filename = path
        self.partial = path + ".partial"
        self.journal_path = path + ".journal"
        close_read_handles(path)

    def _create(self) -> None:
        self.file = hdf5.Writer(self.partial)
        # always present, even in a store that ends up receiving zero chunks:
        # stitch treats an empty predictions group as an empty shard, while a
        # file with NO predictions group stays a hard error
        self.file.create_group(PRED_ROOT)
        self._journal = open(self.journal_path, "wb")
        self._start_write_behind()

    def _recover(self) -> None:
        """Rebuild the tree of a killed run's file from its journal and cut
        the bytes past the last journaled record."""
        end = valid = 0
        for e, valid in _journal(self.journal_path):
            end = max(end, _entry_end(e))
        self.file = hdf5.Writer.reopen(self.partial, end)
        self.file.create_group(PRED_ROOT)
        for e, _ in _journal(self.journal_path):
            if "r" in e:
                contig, cs, ce, addr = e["r"]
                region = f"{contig}-{cs}-{ce}"
                rgrp = self.file.create_group(f"{PRED_ROOT}/{contig}/{region}")
                rgrp.link("contig_start", (), np.int64, addr)
                rgrp.link("contig_end", (), np.int64, addr + 8)
                self._region_groups[region] = rgrp
                continue
            contig, region, chunk, rows, addrs = e["c"]
            self._chunks.add((region, chunk))
            cg = self._region_groups[region].create_group(chunk)
            cg.link("position", (rows, 3), np.uint32, addrs[0])
            cg.link("bases", (rows,), np.uint8, addrs[1])
            cg.link("rles", (rows,), np.uint8, addrs[2])
            if addrs[3] is not None:
                cg.link("quals", (rows,), np.uint8, addrs[3])
        self._journal = open(self.journal_path, "r+b")  # the torn tail goes
        self._journal.truncate(valid)
        self._journal.seek(valid)
        self._start_write_behind()

    def _start_write_behind(self) -> None:
        self._since_kick = 0
        self._kick = threading.Event()
        self._stopping = False
        self._behind_error: Optional[OSError] = None
        self._behind = threading.Thread(target=self._write_behind, args=(self.file.fileno(),),
                                        daemon=True)
        self._behind.start()

    def _write_behind(self, fd: int) -> None:
        """Sync the payload file each time it is kicked, until stopped."""
        while True:
            self._kick.wait()
            self._kick.clear()
            if self._stopping:
                return
            try:
                os.fsync(fd)
            except OSError as exc:  # raised by the next flush
                self._behind_error = exc
                return

    def _stop_write_behind(self) -> None:
        self._stopping = True
        self._kick.set()
        self._behind.join()

    def __enter__(self) -> "PredictionStore":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self.abort()

    def close(self) -> None:
        """Publish the file: its metadata, then the superblock, then its
        name. A store that made no file is left as it was."""
        if self.file is not None:
            self.flush()
            self._stop_write_behind()
            self.file.close(sync=True)
            self.file = None
            os.replace(self.partial, self.filename)
            self._journal.close()
            os.unlink(self.journal_path)

    def abort(self) -> None:
        """Flush (unless a sync has failed) and stop, leaving the file to a
        resumed run (mode "a")."""
        if self.file is not None:
            try:
                if self._behind_error is None:
                    self.flush()
            finally:
                self._stop_write_behind()
                self.file.abandon()
                self.file = None
                self._journal.close()

    def preload_chunk_keys(self, keys) -> None:
        """Union extra (region, chunk) keys into the dedupe set — used by a
        resumed run to skip chunks that live in OTHER shard files (e.g. a
        previous --writers pool's shards)."""
        self._chunks.update(tuple(k) for k in keys)

    def has_chunk(self, contig: str, contig_start: int, contig_end: int,
                  chunk_id: int) -> bool:
        return (f"{contig}-{contig_start}-{contig_end}", str(chunk_id)) in self._chunks

    def write_prediction(
        self,
        contig: str,
        contig_start: int,
        contig_end: int,
        chunk_id: int,
        position: np.ndarray,
        bases: np.ndarray,
        rles: np.ndarray,
        quals: Optional[np.ndarray] = None,
    ) -> bool:
        """Write one image's predictions; duplicate (region, chunk) pairs are
        first-write-wins, matching the reference dedupe (DataStore.py:104-124).

        position is stored as uint32 exactly like the reference
        (DataStore.py:125-127): short images' (-1,-1,-1) padding rows wrap to
        4294967295 on BOTH sides, so the stitch-stage "skip pos<0" check is
        dead for store-read rows in both pipelines; the wrapped rows share
        one key, dedupe to a single entry, and sort to the region tail —
        byte-identical output requires replaying this, so do NOT "fix" the
        dtype here without changing the parity contract."""
        if "/" in contig:
            # '/' is the HDF5 group separator: such a name would silently
            # nest extra groups, splitting the contig across bogus names at
            # stitch (the reference corrupts its store the same way). Fail
            # loudly instead — these names are invalid in the image pipeline.
            raise ValueError(
                f"contig name {contig!r} contains '/', which is not "
                "representable in the prediction-store HDF5 layout"
            )
        region = f"{contig}-{contig_start}-{contig_end}"
        key = (region, str(chunk_id))
        if key in self._chunks:
            return False
        self._chunks.add(key)
        if self.file is None:
            self._create()  # the first new record of a resumed run
        rgrp = self._region_groups.get(region)
        if rgrp is None:
            rgrp = self.file.create_group(f"{PRED_ROOT}/{contig}/{region}")
            rgrp["contig_start"] = np.int64(contig_start)
            rgrp["contig_end"] = np.int64(contig_end)
            self._region_groups[region] = rgrp
            self._pending.append(json.dumps(
                {"r": [contig, int(contig_start), int(contig_end),
                       rgrp["contig_start"].addr]}).encode())
        cg = rgrp.create_group(key[1])
        cg["position"] = np.asarray(position).astype(np.uint32)
        cg["bases"] = np.asarray(bases, dtype=np.uint8)
        cg["rles"] = np.asarray(rles, dtype=np.uint8)
        if quals is not None:
            # optional per-column phred confidence (--qualities); an EXTRA
            # dataset inside the chunk group, invisible to schema-compatible
            # readers that only fetch position/bases/rles
            cg["quals"] = np.asarray(quals, dtype=np.uint8)
        addrs = [cg[n].addr if n in cg else None
                 for n in ("position", "bases", "rles", "quals")]
        self._pending.append(json.dumps(
            {"c": [contig, region, key[1], int(cg["bases"].shape[0]),
                   [None if a == hdf5.UNDEF else a for a in addrs]]}).encode())
        self._since_kick += 1
        if self._since_kick == WRITE_BEHIND_RECORDS:
            self._since_kick = 0
            self.file.flush()  # to the OS, where the write-behind thread syncs it
            self._kick.set()
        return True

    def flush(self) -> None:
        """Sync the payloads written since the last flush, then journal
        them: after this a killed run resumes with every record so far."""
        if self.file is None:
            return
        if self._behind_error is not None:
            raise self._behind_error
        self.file.sync()
        if self._pending:
            self._journal.write(b"\n".join(self._pending) + b"\n")
            self._pending = []
        self._journal.flush()
        os.fsync(self._journal.fileno())


def list_contigs(prediction_files: List[str]) -> List[str]:
    """Union of contigs across prediction files (reference StitchInterface.py:50-65)."""
    contigs: Set[str] = set()
    for path in prediction_files:
        with hdf5.File(path) as f:
            if PRED_ROOT not in f:
                raise ValueError(f"{path}: no '{PRED_ROOT}' group — not a prediction file")
            contigs.update(f[PRED_ROOT].keys())
    return sorted(contigs)


def _region_span_from_key(region_key: str, contig: str) -> "Optional[Tuple[int, int]]":
    """Parse (contig_start, contig_end) out of a region group NAME.

    Both this store and the reference DataStore name region groups
    ``{contig}-{contig_start}-{contig_end}`` (DataStore.py:108,
    write_prediction above), so the span is recoverable without opening the
    group's two scalar datasets — at genome scale those two dataset reads
    per region per shard were ~25% of single-process stitch time (helen_tpu,
    h5py). Returns None
    (caller falls back to reading the datasets) for any name that doesn't
    match, e.g. a contig whose own name ends in ``-<digits>-<digits>``
    written by some third-party producer with a different convention."""
    prefix = contig + "-"
    if not region_key.startswith(prefix):
        return None
    parts = region_key[len(prefix):].split("-")
    if len(parts) != 2:
        return None
    # strict ASCII digits only: bare int() also accepts signs, whitespace
    # and underscore separators (int('1_0') == 10), so a third-party name
    # like 'chr1-1_0-2_0' would parse "successfully" to a WRONG span
    # instead of taking the documented dataset-read fallback. isascii()
    # first because Unicode digit-CLASS characters (e.g. superscripts)
    # pass isdigit() yet crash int().
    if not all(p.isascii() and p.isdigit() for p in parts):
        return None
    return int(parts[0]), int(parts[1])


def list_region_keys(
    prediction_files: List[str], contig: str
) -> List[Tuple[Tuple[str, ...], str, int, int]]:
    """All (files, region_key, start, end) tuples for a contig, with each
    region grouped across every prediction file that holds chunks of it
    (reference StitchInterface.py:82-95 — but cross-file: image-granular
    multi-host sharding can land different chunks of one region in different
    host shards, and the stitcher must merge them positionally, never join
    partial per-file sequences)."""
    regions: Dict[str, Tuple[List[str], int, int]] = {}
    for path in sorted(prediction_files):
        cgrp = _contig_group(path, contig)  # cached per-thread
        if cgrp is None:
            continue
        for region_key in sorted(cgrp.keys()):
            if region_key in regions:
                regions[region_key][0].append(path)
                continue
            span = _region_span_from_key(region_key, contig)
            if span is None:
                grp = cgrp[region_key]
                span = (int(grp["contig_start"][()]),
                        int(grp["contig_end"][()]))
            regions[region_key] = ([path], span[0], span[1])
    out = [
        (tuple(paths), region_key, start, end)
        for region_key, (paths, start, end) in regions.items()
    ]
    return sorted(out, key=lambda t: (t[2], t[3]))


def read_region_chunks(
    paths: Sequence[str], contig: str, region_key: str, with_quals: bool = False
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield (position, bases, rles) per image chunk of a region, merged
    across prediction files, in globally sorted chunk-NAME order — the
    lexicographic string sort is deliberate: the reference also sorts the
    HDF5 group-name strings (Stitch.py:209-211, ``sorted(smaller_chunks)``),
    so for regions with >= 10 chunks the first-write-wins winner on
    overlapping positions must follow string order ('10' < '2') to stitch
    identical sequences. A chunk present in several files (e.g. an
    overlapping resumed run) is taken from the first file in sorted-path
    order, matching the store's first-write-wins dedupe.

    ``with_quals=True`` yields 4-tuples whose last element is the chunk's
    per-column phred array, or None when the store has no ``quals`` dataset
    (written by ``--qualities`` runs only)."""
    per_file = []
    for path in sorted(paths):
        rgrp = _contig_group(path, contig)[region_key]  # contig group cached per-thread
        per_file.append(({n for n in rgrp.keys()
                          if n not in ("contig_start", "contig_end")}, rgrp))
    all_names = sorted({name for names, _ in per_file for name in names})
    for name in all_names:
        for names, rgrp in per_file:
            if name in names:
                cg = rgrp[name]
                # position widens to int64 (uint32-wrapped padding rows
                # participate in sorting); bases/rles stay uint8 — rle_decode
                # consumes them at that width
                out = (cg["position"][()].astype(np.int64), cg["bases"][()],
                       cg["rles"][()])
                if with_quals:
                    out = out + (cg["quals"][()] if "quals" in cg else None,)
                yield out
                break


def read_prediction_regions(
    path: str, contig: str, region_key: str
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Single-file variant of read_region_chunks."""
    yield from read_region_chunks([path], contig, region_key)
