"""Training-log summarizer (reference helper/csv_analyzer.py equivalent).

Reads the train_loss.csv / test_loss.csv written by the trainer and prints
per-epoch summaries plus the best epoch.
"""
from __future__ import annotations

import argparse
import csv
from collections import defaultdict


def summarize_train(path: str):
    per_epoch = defaultdict(list)
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                per_epoch[int(row[0])].append(float(row[2]))
    return {e: vals[-1] for e, vals in sorted(per_epoch.items())}


def summarize_test(path: str):
    out = {}
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 3:
                out[int(row[0])] = (float(row[1]), float(row[2]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="summarize training CSV logs")
    ap.add_argument("--train_csv")
    ap.add_argument("--test_csv")
    args = ap.parse_args(argv)
    if not args.train_csv and not args.test_csv:
        ap.error("provide --train_csv and/or --test_csv")
    if args.train_csv:
        print("epoch  final avg train loss")
        for e, loss in summarize_train(args.train_csv).items():
            print(f"{e:>5}  {loss:.6f}")
    if args.test_csv:
        stats = summarize_test(args.test_csv)
        print("epoch  test loss   accuracy%")
        for e, (loss, acc) in sorted(stats.items()):
            print(f"{e:>5}  {loss:.6f}  {acc:8.3f}")
        if stats:
            best = min(stats.items(), key=lambda kv: kv[1][0])
            print(f"best epoch: {best[0]} (test loss {best[1][0]:.6f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
