"""Position-by-position comparison of two MarginPolish image files.

Equivalent of the reference's helper/hdf5_reader.py, which diffs HELEN
features/labels against another polisher's HDF5 (Medaka) as a
cross-implementation validation tool. Here both sides use the MarginPolish
schema; the tool reports positions whose features or labels disagree.
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np

from helen_tpu_torch.io.images import MarginPolishDataset


def index_by_position(ds: MarginPolishDataset, with_labels: bool):
    """(contig, pos, insert, split) -> (features, label_base, label_rle)."""
    out: Dict[Tuple, Tuple] = {}
    for i in range(len(ds)):
        rec = ds.load(i)
        for j in range(rec.image.shape[0]):
            p = rec.position[j]
            if p[0] < 0:
                continue
            key = (rec.contig, int(p[0]), int(p[1]), int(p[2]))
            if key in out:
                continue
            lb = int(rec.label_base[j]) if with_labels and rec.label_base is not None else None
            lr = int(rec.label_rle[j]) if with_labels and rec.label_rle is not None else None
            out[key] = (rec.image[j], lb, lr)
    return out


def compare(file_a: str, file_b: str, with_labels: bool = True, max_report: int = 50):
    a = index_by_position(MarginPolishDataset([file_a], with_labels=with_labels), with_labels)
    b = index_by_position(MarginPolishDataset([file_b], with_labels=with_labels), with_labels)
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    feature_diff = []
    label_diff = []
    for key in sorted(set(a) & set(b)):
        fa, lba, lra = a[key]
        fb, lbb, lrb = b[key]
        if not np.array_equal(fa, fb):
            feature_diff.append(key)
        if with_labels and (lba, lra) != (lbb, lrb):
            label_diff.append((key, (lba, lra), (lbb, lrb)))
    return {
        "common": len(set(a) & set(b)),
        "only_a": only_a[:max_report],
        "only_b": only_b[:max_report],
        "n_only_a": len(only_a),
        "n_only_b": len(only_b),
        "feature_diff": feature_diff[:max_report],
        "n_feature_diff": len(feature_diff),
        "label_diff": label_diff[:max_report],
        "n_label_diff": len(label_diff),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="diff two image HDF5 files by position")
    ap.add_argument("-a", "--file_a", required=True)
    ap.add_argument("-b", "--file_b", required=True)
    ap.add_argument("--no_labels", action="store_true")
    args = ap.parse_args(argv)
    r = compare(args.file_a, args.file_b, with_labels=not args.no_labels)
    print(f"common positions:   {r['common']}")
    print(f"only in A:          {r['n_only_a']}")
    print(f"only in B:          {r['n_only_b']}")
    print(f"feature mismatches: {r['n_feature_diff']}")
    print(f"label mismatches:   {r['n_label_diff']}")
    for key, la, lb in r["label_diff"]:
        print(f"  {key}: A={la} B={lb}")
    return 0 if (r["n_feature_diff"] == 0 and r["n_label_diff"] == 0
                 and r["n_only_a"] == 0 and r["n_only_b"] == 0) else 1


if __name__ == "__main__":
    raise SystemExit(main())
