#!/usr/bin/env python3
"""Write the golden image file (tests/golden/golden_images.h5.gz) again in
the HDF5 forms h5py and libhdf5 produce beside the earliest contiguous one:

* ``images_v1_chunked.h5``, the earliest format: ``image`` chunked at
  (128, 90) and ``position`` at (128, 3), both with edge chunks, under
  shuffle + gzip, ``position`` also under fletcher32; ``contig`` a
  variable-length ``str``;
* ``images_latest.h5``, ``libver="latest"``: the same datasets, and the
  ``images/`` group in dense storage (a fractal heap and a B-tree of names:
  h5py's choice past 8 links);
* ``images_ub512_lzf.h5``, the earliest format after a 512-byte user block:
  the same datasets, under shuffle + h5py's lzf in place of gzip.

The port reads these through its own reader (helen_tpu_torch/io/hdf5.py),
and polishes each to tests/golden/golden.fa; tests/test_torch_hdf5_variants.py
and chip_smoke.py (phase 13) hold it to that. The files are committed: the
GPU machine has no h5py. Regenerate them on a machine with h5py:

    python tests/torch_hdf5_variants/make_variants.py

Their bytes may differ across h5py versions; their arrays do not.
"""
import gzip
import io
import os

import h5py
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_GZ = os.path.join(HERE, os.pardir, "golden", "golden_images.h5.gz")
# file name: (libver, user block bytes, compression)
VARIANTS = {"images_v1_chunked.h5": ("earliest", 0, "gzip"),
            "images_latest.h5": ("latest", 0, "gzip"),
            "images_ub512_lzf.h5": ("earliest", 512, "lzf")}
CHUNKS = {"image": (128, 90), "position": (128, 3)}


def golden_records():
    """{image name: {dataset: array}} of the golden image file."""
    with gzip.open(GOLDEN_GZ, "rb") as src:
        raw = io.BytesIO(src.read())
    with h5py.File(raw, "r") as f:
        return {name: {k: v[()] for k, v in grp.items()} for name, grp in f["images"].items()}


def variant_records():
    """The arrays each variant holds, as h5py reads them back: the golden
    records with ``contig`` an object array of ``bytes``."""
    out = {}
    for name, ds in golden_records().items():
        ds = dict(ds)
        ds["contig"] = np.array([bytes(c) for c in ds["contig"]], dtype=object)
        out[name] = ds
    return out


def write_variant(path: str, libver: str, userblock: int = 0,
                  compression: str = "gzip") -> None:
    with h5py.File(path, "w", libver=libver, userblock_size=userblock) as f:
        images = f.create_group("images")
        for name, ds in golden_records().items():
            g = images.create_group(name)
            for key, value in ds.items():
                if key in CHUNKS:  # an image shorter than a chunk is one chunk
                    chunks = tuple(min(c, n) for c, n in zip(CHUNKS[key], value.shape))
                    g.create_dataset(key, data=value, chunks=chunks, shuffle=True,
                                     compression=compression, fletcher32=key == "position")
                elif key == "contig":
                    g.create_dataset(key, data=[c.decode() for c in value],
                                     dtype=h5py.string_dtype())
                else:
                    g[key] = value


def main() -> None:
    for name, form in VARIANTS.items():
        path = os.path.join(HERE, name)
        write_variant(path, *form)
        print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
