"""Cross-reference QUAST misassemblies with known structural variants.

Equivalent of the reference's helper/quast_sv_extractor.py: parses a QUAST
contigs report of misassembly records and a BED of known SVs, and counts how
many reported misassemblies overlap a known SV (those are likely real
biology, not polisher errors).
"""
from __future__ import annotations

import argparse
import re
from collections import defaultdict
from typing import Dict, List, Tuple

_COORD_RE = re.compile(r"(\S+):(\d+)-(\d+)")


def read_bed(path: str) -> Dict[str, List[Tuple[int, int]]]:
    out = defaultdict(list)
    with open(path) as f:
        for line in f:
            if line.startswith(("#", "track", "browser")) or not line.strip():
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                parts = line.split()
            out[parts[0]].append((int(parts[1]), int(parts[2])))
    for v in out.values():
        v.sort()
    return out


def read_misassemblies(path: str) -> List[Tuple[str, int, int, str]]:
    """Extract (chrom, start, end, kind) from QUAST's misassembly report
    lines (contigs_report_*.mis_contigs.info / stdout formats)."""
    out = []
    kind = "misassembly"
    with open(path) as f:
        for line in f:
            low = line.lower()
            for k in ("relocation", "translocation", "inversion", "local misassembly"):
                if k in low:
                    kind = k
            for m in _COORD_RE.finditer(line):
                out.append((m.group(1), int(m.group(2)), int(m.group(3)), kind))
    return out


def overlaps(intervals: List[Tuple[int, int]], start: int, end: int, slop: int) -> bool:
    for s, e in intervals:
        if s - slop <= end and start <= e + slop:
            return True
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="count QUAST misassemblies explained by known SVs"
    )
    ap.add_argument("-q", "--quast_report", required=True)
    ap.add_argument("-s", "--sv_bed", required=True)
    ap.add_argument("--slop", type=int, default=1000,
                    help="bp tolerance around SV intervals")
    args = ap.parse_args(argv)
    svs = read_bed(args.sv_bed)
    mis = read_misassemblies(args.quast_report)
    explained = 0
    by_kind = defaultdict(lambda: [0, 0])
    for chrom, start, end, kind in mis:
        hit = overlaps(svs.get(chrom, []), start, end, args.slop)
        explained += hit
        by_kind[kind][0] += hit
        by_kind[kind][1] += 1
    print(f"misassemblies:        {len(mis)}")
    print(f"explained by SVs:     {explained}")
    print(f"unexplained:          {len(mis) - explained}")
    for kind, (hit, total) in sorted(by_kind.items()):
        print(f"  {kind:<20} {hit}/{total} explained")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
