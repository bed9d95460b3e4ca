"""Benchmark diff tool (the `archery benchmark diff` analogue,
reference: dev/archery/archery/benchmark/{runner,compare,google}.py).

Usage:
  python benchmarks/compare.py baseline.json contender.json [--threshold 0.05]

Reads run_benchmarks.py output ({"benchmarks": [...]}). Exit code 1 if
any benchmark regressed beyond the threshold.
"""

from __future__ import annotations

import argparse
import json
import sys


def load(path):
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, dict) and "benchmarks" in data:
        return {b["benchmark"]: {"rows_per_sec": b["rows_per_sec"]}
                for b in data["benchmarks"]}
    raise ValueError(f"unrecognized benchmark file format: {path}")


def diff(base, cont, threshold=0.05, out=sys.stdout):
    regressions = 0
    args_threshold = threshold
    rows = []
    for name in sorted(set(base) | set(cont)):
        b = base.get(name)
        c = cont.get(name)
        if b is None or c is None:
            rows.append((name, "added" if b is None else "removed", ""))
            continue
        ratio = c["rows_per_sec"] / b["rows_per_sec"]
        change = (ratio - 1) * 100
        flag = ""
        if ratio < 1 - args_threshold:
            flag = "REGRESSION"
            regressions += 1
        elif ratio > 1 + args_threshold:
            flag = "improvement"
        rows.append((name, f"{change:+.1f}%", flag))
    width = max(len(r[0]) for r in rows) if rows else 20
    for name, change, flag in rows:
        print(f"{name:<{width}}  {change:>10}  {flag}", file=out)
    return regressions


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline")
    ap.add_argument("contender")
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="relative regression threshold")
    args = ap.parse_args()
    regressions = diff(load(args.baseline), load(args.contender),
                       args.threshold)
    sys.exit(1 if regressions else 0)


if __name__ == "__main__":
    main()
