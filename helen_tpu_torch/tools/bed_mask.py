"""Mask BED regions of a FASTA with Ns.

Companion to assessment workflows: the reference ships
masked_regions/GRCh38_masked_regions.bed for excluding known-problematic
regions from polishing evaluation; this tool applies such a BED to a FASTA
(e.g. before computing error rates) without needing bedtools.

Two modes:

* **coordinate masking** (default): intervals are applied at their BED
  coordinates. Exact for the truth FASTA (BED coordinates ARE truth-space),
  but on a POLISHED sequence indels upstream of an interval shift the
  sequence against the coordinates, so edits can leak across mask
  boundaries (the caveat previously documented in tools/assess_polish).
* **anchored masking** (``--anchor_truth``): each interval's flanking truth
  sequence is located in the polished sequence with the in-repo SSW
  aligner (stitch.aligner — the same native core the stitch engine uses)
  and the region BETWEEN the anchors is masked. The masked span then
  tracks the sequence, not the coordinates, so masked assessment is exact
  under upstream indels (VERDICT r4 item 7; the reference reaches the same
  invariance indirectly through QUAST's whole-genome alignment).
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from helen_tpu_torch.io.fasta import read_fasta, write_fasta
from helen_tpu_torch.obs import get_logger
from helen_tpu_torch.tools.quast_sv_extractor import read_bed

log = get_logger("bed_mask")


def mask_fasta(in_fasta: str, bed: str, out_fasta: str) -> int:
    """Replace BED intervals with Ns; returns total masked bases."""
    intervals = read_bed(bed)
    masked = 0

    def records():
        nonlocal masked
        for name, seq in read_fasta(in_fasta):
            if name in intervals:
                chars = list(seq)
                for start, end in intervals[name]:
                    start = max(0, start)
                    end = min(len(chars), end)
                    for i in range(start, end):
                        if chars[i] != "N":
                            chars[i] = "N"
                            masked += 1
                seq = "".join(chars)
            yield name, seq

    write_fasta(out_fasta, records())
    return masked


def _mask_span(chars: List[str], start: int, end: int) -> int:
    start = max(0, start)
    end = min(len(chars), end)
    masked = 0
    for i in range(start, end):
        if chars[i] != "N":
            chars[i] = "N"
            masked += 1
    return masked


def _anchor(aligner, alignment_cls, polished: str, flank_seq: str,
            expected: int, search_pad: int, side: str) -> Optional[int]:
    """Locate a truth flank in the polished sequence near ``expected``.

    Returns the polished-space coordinate of the flank's INNER edge — for
    ``side='left'`` the position just after the flank (the mask start), for
    ``side='right'`` the position where the flank begins (the mask end) —
    or None when the anchor does not align confidently (the caller falls
    back to coordinate masking). Unaligned flank tails (soft clips at the
    window edge) are added back arithmetically so the inner edge is exact
    even when SSW clips the outer end."""
    if not flank_seq:
        return None
    w0 = max(0, expected - search_pad)
    w1 = min(len(polished), expected + search_pad + len(flank_seq))
    if w1 <= w0:
        return None
    aligner.SetReferenceSequence(polished[w0:w1])
    aln = alignment_cls()
    if not aligner.align(flank_seq, aln) or aln.best_score <= 0:
        return None
    # confidence: at polishing-grade divergence the flank aligns near-
    # perfectly (match=+2), so require >=75% of the perfect score — a
    # repeat/soft-clip mis-anchor scores far lower
    if aln.best_score < 1.5 * len(flank_seq):
        return None
    if side == "left":
        tail = len(flank_seq) - 1 - aln.query_end  # clipped inner tail
        return w0 + aln.reference_end + 1 + tail
    return w0 + aln.reference_begin - aln.query_begin


def anchored_mask_fasta(
    polished_fasta: str,
    truth_fasta: str,
    bed: str,
    out_polished: str,
    flank: int = 300,
    search_pad: int = 0,
    out_truth: Optional[str] = None,
) -> dict:
    """Mask truth-space BED intervals in a POLISHED FASTA by anchoring each
    interval's truth flanks in polished space with the native SSW aligner.

    Returns stats: masked base counts, anchored/fallback interval counts.
    ``out_truth`` optionally also writes the coordinate-masked truth (the
    matching other half of a masked assessment). ``search_pad=0`` auto-sizes
    the anchor search window per contig from the observed length drift.

    Assessment semantics of the masked pair: substitutions inside a masked
    interval vanish (N == N); a NET indel inside one still contributes
    |length change| edits because the two N runs differ in length —
    matching how an alignment-based pipeline scores a masked region's
    length disagreement."""
    from helen_tpu_torch.stitch.aligner import Aligner, Alignment

    intervals = read_bed(bed)
    truth = dict(read_fasta(truth_fasta))
    aligner = Aligner()  # SSW defaults: +2 match / -2 / -3 / -1
    stats = {"masked_polished": 0, "masked_truth": 0,
             "anchored": 0, "fallback": 0}

    def polished_records():
        for name, seq in read_fasta(polished_fasta):
            if name not in intervals or name not in truth:
                yield name, seq
                continue
            t = truth[name]
            pad = search_pad or max(2000, 2 * abs(len(seq) - len(t)) + 500)
            chars = list(seq)
            for start, end in intervals[name]:
                # expected polished position: truth coordinate scaled by
                # the contig length ratio (drift is at most the length
                # difference; the SSW anchor absorbs the rest)
                scale = len(seq) / max(1, len(t))
                p_start = p_end = None
                if start <= 0:
                    p_start = 0
                else:
                    p_start = _anchor(aligner, Alignment, seq,
                                      t[max(0, start - flank):start],
                                      int(start * scale) - flank, pad, "left")
                if end >= len(t):
                    p_end = len(chars)
                elif p_start is not None:
                    p_end = _anchor(aligner, Alignment, seq,
                                    t[end:end + flank],
                                    int(end * scale), pad, "right")
                if p_start is None or p_end is None or p_end < p_start:
                    log.warning(
                        "%s:%d-%d: flank anchor failed; falling back to "
                        "coordinate masking", name, start, end)
                    stats["fallback"] += 1
                    p_start, p_end = start, end
                else:
                    stats["anchored"] += 1
                stats["masked_polished"] += _mask_span(chars, p_start, p_end)
            yield name, "".join(chars)

    write_fasta(out_polished, polished_records())
    if out_truth:
        stats["masked_truth"] = mask_fasta(truth_fasta, bed, out_truth)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="mask BED regions of a FASTA with Ns (coordinate "
                    "masking, or SSW-anchored masking of a polished FASTA "
                    "against truth-space BED coordinates)")
    ap.add_argument("-i", "--input_fasta", required=True)
    ap.add_argument("-b", "--bed", required=True)
    ap.add_argument("-o", "--output_fasta", required=True)
    ap.add_argument("--anchor_truth", default=None,
                    help="truth FASTA: treat -i as a POLISHED assembly and "
                         "anchor each interval's truth flanks in it with "
                         "the native SSW aligner before masking (exact "
                         "under upstream indels)")
    ap.add_argument("--truth_out", default=None,
                    help="with --anchor_truth: also write the coordinate-"
                         "masked truth FASTA here (the other half of a "
                         "masked assessment)")
    ap.add_argument("--flank", type=int, default=300,
                    help="anchor flank length (default 300)")
    ap.add_argument("--search_pad", type=int, default=0,
                    help="anchor search half-window (default: auto from "
                         "the contig length drift)")
    args = ap.parse_args(argv)
    if args.anchor_truth:
        stats = anchored_mask_fasta(
            args.input_fasta, args.anchor_truth, args.bed,
            args.output_fasta, flank=args.flank,
            search_pad=args.search_pad, out_truth=args.truth_out)
        print(f"masked {stats['masked_polished']} bases "
              f"({stats['anchored']} intervals anchored, "
              f"{stats['fallback']} coordinate fallbacks)"
              + (f"; truth: {stats['masked_truth']} bases"
                 if args.truth_out else ""))
        return 0
    n = mask_fasta(args.input_fasta, args.bed, args.output_fasta)
    print(f"masked {n} bases")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
