"""Reduce pomoxis assess_assembly summaries to one table.

Equivalent of the reference's helper/assess_summary_analyzer.py: collects the
Q-scores / error rates from one or more ``assess_assembly`` summary text
files and prints a comparison table.
"""
from __future__ import annotations

import argparse
import re
from typing import Dict

_PATTERNS = {
    "err_ont": re.compile(r"err_ont\s+([0-9.eE+-]+)"),
    "err_bal": re.compile(r"err_bal\s+([0-9.eE+-]+)"),
    "iden": re.compile(r"iden\s+([0-9.eE+-]+)"),
    "del": re.compile(r"\bdel\s+([0-9.eE+-]+)"),
    "ins": re.compile(r"\bins\s+([0-9.eE+-]+)"),
}


def parse_summary(path: str) -> Dict[str, float]:
    text = open(path).read()
    # pomoxis prints two sections that REUSE metric names: "# Percentage
    # Errors" (err_ont as a percent, e.g. 0.209%) then "# Q Scores" (err_ont
    # as a Q value). Split at the Q-Scores header so the same regexes read
    # the right section.
    parts = re.split(r"#\s*Q[ _]?Scores", text, flags=re.IGNORECASE)
    out = {}
    for key, pat in _PATTERNS.items():
        m = pat.search(parts[0])
        if m:
            out[key] = float(m.group(1))
    if len(parts) > 1:
        m = _PATTERNS["err_ont"].search(parts[1])
        if m:
            out["Qscore"] = float(m.group(1))
    if "Qscore" not in out and out.get("err_ont", 0) > 0:
        import math

        # err_ont is a PERCENTAGE in the summary
        out["Qscore"] = -10.0 * math.log10(out["err_ont"] / 100.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="summarize assess_assembly outputs")
    ap.add_argument("summaries", nargs="+", help="assess summary text files")
    args = ap.parse_args(argv)
    keys = ["err_ont", "err_bal", "iden", "del", "ins", "Qscore"]
    print(f"{'file':<40}" + "".join(f"{k:>10}" for k in keys))
    for path in args.summaries:
        stats = parse_summary(path)
        row = "".join(
            f"{stats[k]:>10.4g}" if k in stats else f"{'-':>10}" for k in keys
        )
        print(f"{path:<40}{row}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
