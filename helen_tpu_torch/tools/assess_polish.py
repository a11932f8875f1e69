"""Self-contained polishing assessment: polished FASTA vs truth FASTA.

The reference's assessment workflow shells out to external aligners/QUAST
and post-processes their reports (its helper scripts — here
tools/quast_sv_extractor.py, tools/assess_summary.py — consume those
outputs). This tool closes the loop WITHOUT external binaries for the
common case where a truth sequence exists per contig (synthetic validation,
re-polishing a curated assembly): per-contig edit distance via a native
banded Ukkonen DP (native/helen_stitch.cpp helen_banded_edit_distance —
O(len * band) time, O(band) memory; the band doubles until the distance is
provably exact), reported as error rate and phred Q per contig and overall.

Masked-regions flow (the reference's GRCh38 assessment protocol,
masked_regions/README.md): mask the polished FASTA with
``tools.bed_mask --anchor_truth truth.fa --truth_out truth_masked.fa`` —
the BED coordinates are truth-space, so the polished side is masked by
SSW-ANCHORING each interval's truth flanks in polished space (exact under
indels upstream of an interval; plain coordinate masking would let edits
leak across mask boundaries as the sequences drift) — then assess the two
masked outputs with this tool.

Usage:
  python -m helen_tpu_torch.tools.assess_polish -t truth.fa -p polished.fa
      [--max_band 65536] [--json]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, Optional

from helen_tpu_torch.io.fasta import read_fasta
from helen_tpu_torch.stitch._native import get_lib


def edit_distance(a: str, b: str, max_band: int = 1 << 20) -> Optional[int]:
    """Exact Levenshtein distance of two near-identical sequences via the
    native banded DP; None when the distance exceeds ``max_band`` (the
    sequences are not near-identical — report them as unalignable rather
    than spending O(n^2)).

    Comparison is case-insensitive: truth references are commonly
    soft-masked (lowercase repeats, e.g. GRCh38 releases) while polished
    output is uppercase; counting case differences as edits would inflate
    error rates by the soft-masked fraction. The reference's QUAST/aligner
    assessment is likewise case-insensitive."""
    lib = get_lib()
    ab, bb = a.upper().encode(), b.upper().encode()
    if ab == bb:
        return 0
    # the band sequence is CLAMPED to end exactly at max_band so every
    # distance <= max_band is findable (a doubling-only sequence would
    # skip the (last_power_of_2, max_band] range, and a length gap with
    # 2*gap > max_band would skip the search entirely)
    band = min(max(16, 2 * abs(len(a) - len(b))), max_band)
    while True:
        d = lib.helen_banded_edit_distance(ab, len(ab), bb, len(bb), band)
        if d >= 0:
            return int(d)
        if band >= max_band:
            return None
        band = min(band * 2, max_band)


def _q(err: float, cap: float = 90.0) -> float:
    if err <= 0:
        return cap
    return min(cap, -10.0 * math.log10(err))


def assess(truth: Dict[str, str], polished: Dict[str, str],
           max_band: int = 1 << 20) -> dict:
    rows = []
    total_len = total_edits = 0
    unalignable = []
    missing = sorted(set(truth) - set(polished))
    extra = sorted(set(polished) - set(truth))
    for name in sorted(set(truth) & set(polished)):
        t, p = truth[name], polished[name]
        d = edit_distance(t, p, max_band)
        if d is None:
            unalignable.append(name)
            continue
        err = d / max(1, len(t))
        rows.append({
            "contig": name, "truth_len": len(t), "polished_len": len(p),
            "edits": d, "error_rate": err, "q": round(_q(err), 2),
        })
        total_len += len(t)
        total_edits += d
    err = total_edits / max(1, total_len)
    return {
        "contigs": rows,
        "missing_contigs": missing,
        "extra_contigs": extra,
        "unalignable_contigs": unalignable,
        "total_truth_bases": total_len,
        "total_edits": total_edits,
        "error_rate": err,
        "q": round(_q(err), 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-contig edit distance / error rate / Q of a "
                    "polished FASTA against a truth FASTA")
    ap.add_argument("-t", "--truth", required=True)
    ap.add_argument("-p", "--polished", required=True)
    ap.add_argument("--max_band", type=int, default=1 << 20,
                    help="give up (report unalignable) past this edit "
                         "distance per contig")
    ap.add_argument("--json", action="store_true",
                    help="print the full JSON report instead of the table")
    ap.add_argument("-b", "--bed", default=None,
                    help="masked-regions BED (truth-space coordinates, e.g. "
                         "masked_regions/GRCh38_masked_regions.bed): mask "
                         "the truth at its coordinates and the polished "
                         "sequence via SSW-anchored flanks (tools.bed_mask "
                         "--anchor_truth) before assessing — exact under "
                         "indels upstream of masked intervals")
    args = ap.parse_args(argv)
    mask_stats = None
    if args.bed:
        import tempfile

        from helen_tpu_torch.tools.bed_mask import anchored_mask_fasta

        with tempfile.TemporaryDirectory(prefix="helen_assess_mask_") as td:
            pol_m = f"{td}/polished_masked.fa"
            tru_m = f"{td}/truth_masked.fa"
            mask_stats = anchored_mask_fasta(
                args.polished, args.truth, args.bed, pol_m, out_truth=tru_m)
            print(f"# masked {mask_stats['masked_truth']} truth / "
                  f"{mask_stats['masked_polished']} polished bases "
                  f"({mask_stats['anchored']} intervals anchored, "
                  f"{mask_stats['fallback']} coordinate fallbacks)",
                  file=sys.stderr)
            truth = dict(read_fasta(tru_m))
            polished = dict(read_fasta(pol_m))
    else:
        truth = dict(read_fasta(args.truth))
        polished = dict(read_fasta(args.polished))
    report = assess(truth, polished, args.max_band)
    if mask_stats is not None:
        report["masking"] = mask_stats
    if args.json:
        print(json.dumps(report))
    else:
        for r in report["contigs"]:
            print(f"{r['contig']}\t{r['truth_len']}\t{r['edits']} edits\t"
                  f"err {r['error_rate']:.2e}\tQ{r['q']}")
        for name in report["missing_contigs"]:
            print(f"{name}\tMISSING from polished output")
        for name in report["extra_contigs"]:
            print(f"{name}\tEXTRA in polished output (no truth sequence)")
        for name in report["unalignable_contigs"]:
            print(f"{name}\tUNALIGNABLE (distance > --max_band)")
        print(f"TOTAL\t{report['total_truth_bases']}\t"
              f"{report['total_edits']} edits\t"
              f"err {report['error_rate']:.2e}\tQ{report['q']}")
    return 0 if not (report["missing_contigs"]
                     or report["unalignable_contigs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
