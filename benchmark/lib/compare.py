"""The numbers that decide ``correct``, each held to a limit of its own."""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, List, Sequence, Tuple

import torch

#: a leaf whose first gradient, by the reference, is under this share of the
#: median leaf's moves under Adam by round-off alone: it is not compared
NOUGHT_GRADIENT = 1e-3


def vote_gap(ref_votes: Sequence[torch.Tensor], labels: Sequence[torch.Tensor]
             ) -> Tuple[float, int]:
    """The widest gap by which the reference's vote for a label that was
    served lies below the reference's best vote in its column, over both
    heads; and the number of labels that are not the reference's argmax."""
    gap, flips = 0.0, 0
    for votes, lab in zip(ref_votes, labels):
        best = votes.amax(dim=-1)
        got = votes.gather(-1, lab.long().to(votes.device)[..., None])[..., 0]
        gap = max(gap, float((best - got).max()))
        flips += int((votes.argmax(dim=-1) != lab.to(votes.device)).sum())
    return gap, flips


def relative_gap(values: Sequence[float], ref: Sequence[float]) -> float:
    """The largest |value - ref| / |ref|."""
    return max(abs(v - r) / abs(r) for v, r in zip(values, ref))


def leaf_norm_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                  counted: Sequence[bool]) -> float:
    """The worst counted leaf's gap between the program's norm and the
    reference's, against the larger of the reference's norm of that leaf
    and of the median leaf."""
    ref_norms = [float(r.norm()) for r in ref]
    floor = median(n for n, c in zip(ref_norms, counted) if c)
    return max(abs(float(p.norm()) - r) / max(r, floor)
               for p, r, c in zip(prog, ref_norms, counted) if c)


def counted_leaves(ref_first_moment: Sequence[torch.Tensor]) -> List[bool]:
    """The leaves whose reference gradient is not nought to rounding."""
    norms = [float(m.norm()) for m in ref_first_moment]
    mid = median(norms)
    return [n >= NOUGHT_GRADIENT * mid for n in norms]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """Whether every number is within its limit (a number that is missing
    or not finite fails), and ``{name: {"value", "limit"}}``."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        finite = math.isfinite(value)
        compared[name] = {"value": value if finite else None, "limit": limit}
        ok = ok and finite and value <= limit
    return ok, compared
