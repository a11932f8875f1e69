"""K-mer-seeded pairwise alignment experiment.

Equivalent of the reference's dev-only PairwiseAlignment.py (modules/python/
PairwiseAlignment.py): finds shared k-mers between two sequences to pick a
candidate anchor window, then runs the native SSW aligner over it. Useful for
probing stitch behavior on hand-picked sequence pairs (the reference's
helper/test_pairwisealigner.py smoke test maps to ``main`` here).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from helen_tpu_torch.config import STITCH
from helen_tpu_torch.stitch import Aligner, Alignment, Filter


def kmer_index(seq: str, k: int) -> Dict[str, List[int]]:
    out: Dict[str, List[int]] = {}
    for i in range(len(seq) - k + 1):
        out.setdefault(seq[i : i + k], []).append(i)
    return out


def seed_match(seq_a: str, seq_b: str, k: int = STITCH.kmer_size) -> Optional[Tuple[int, int]]:
    """First shared k-mer (pos_a, pos_b), or None."""
    index = kmer_index(seq_a, k)
    for j in range(len(seq_b) - k + 1):
        hits = index.get(seq_b[j : j + k])
        if hits:
            return hits[0], j
    return None


def align_pair(seq_a: str, seq_b: str, cfg=STITCH) -> Alignment:
    aligner = Aligner(cfg.match_score, cfg.mismatch_penalty,
                      cfg.gap_open_penalty, cfg.gap_extend_penalty)
    aligner.SetReferenceSequence(seq_a, len(seq_a))
    alignment = Alignment()
    aligner.Align_cpp(seq_b, Filter(), alignment, 0)
    return alignment


def anchored_align(
    seq_a: str, seq_b: str, k: int = STITCH.kmer_size, pad: int = 500, cfg=STITCH
):
    """Seed with the first shared k-mer and align only a +/-``pad`` window of
    seq_a around it (the documented anchored behavior): returns
    (seed, window_start, alignment) with alignment coordinates relative to
    the window. Falls back to a full-sequence alignment when no k-mer is
    shared (seed None, window_start 0)."""
    seed = seed_match(seq_a, seq_b, k)
    if seed is None:
        return None, 0, align_pair(seq_a, seq_b, cfg)
    pos_a, pos_b = seed
    start = max(0, pos_a - pos_b - pad)
    end = min(len(seq_a), pos_a - pos_b + len(seq_b) + pad)
    return seed, start, align_pair(seq_a[start:end], seq_b, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="k-mer-seeded SSW alignment of two sequences")
    ap.add_argument("seq_a")
    ap.add_argument("seq_b")
    ap.add_argument("-k", "--kmer", type=int, default=STITCH.kmer_size)
    ap.add_argument("--pad", type=int, default=500,
                    help="window padding around the seeded anchor")
    args = ap.parse_args(argv)
    seed, start, al = anchored_align(args.seq_a, args.seq_b, args.kmer, args.pad)
    print(f"seed k-mer match: {seed} (window start {start})")
    print(f"score={al.best_score} "
          f"ref=[{start + al.reference_begin},{start + al.reference_end}] "
          f"query=[{al.query_begin},{al.query_end}] cigar={al.cigar_string}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
