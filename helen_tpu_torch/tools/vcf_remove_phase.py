"""Strip phasing from VCF genotypes.

Equivalent of the reference's helper/VCF_remove_phase.py (which used pysam):
rewrites ``|``-phased GT fields as unphased ``/`` genotypes, sorted
numerically, and drops phase-set (PS) annotations. Pure text processing —
works on any VCF without htslib.
"""
from __future__ import annotations

import argparse
import gzip
import sys


def unphase_gt(gt: str) -> str:
    if "|" not in gt:
        return gt
    alleles = gt.split("|")
    try:
        alleles = sorted(alleles, key=lambda a: (a == ".", int(a) if a != "." else 0))
    except ValueError:
        pass
    return "/".join(alleles)


def process_line(line: str) -> str:
    if line.startswith("#"):
        return line
    cols = line.rstrip("\n").split("\t")
    if len(cols) < 10:
        return line
    fmt = cols[8].split(":")
    keep = [i for i, k in enumerate(fmt) if k != "PS"]
    cols[8] = ":".join(fmt[i] for i in keep)
    gt_idx = fmt.index("GT") if "GT" in fmt else None
    for s in range(9, len(cols)):
        fields = cols[s].split(":")
        fields = [fields[i] for i in keep if i < len(fields)]
        if gt_idx is not None:
            # compare GT's POST-filter position against the filtered list —
            # the pre-filter index is wrong whenever a stripped key (PS)
            # precedes GT
            new_gt_pos = keep.index(gt_idx)
            if new_gt_pos < len(fields):
                fields[new_gt_pos] = unphase_gt(fields[new_gt_pos])
        cols[s] = ":".join(fields)
    return "\t".join(cols) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="remove phasing from VCF genotypes")
    ap.add_argument("-i", "--input_vcf", required=True)
    ap.add_argument("-o", "--output_vcf", required=True)
    args = ap.parse_args(argv)
    opener = gzip.open if args.input_vcf.endswith(".gz") else open
    out_opener = gzip.open if args.output_vcf.endswith(".gz") else open
    n = 0
    with opener(args.input_vcf, "rt") as fin, out_opener(args.output_vcf, "wt") as fout:
        for line in fin:
            fout.write(process_line(line))
            n += 1
    print(f"processed {n} lines", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
