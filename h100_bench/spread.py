"""Run one cell several times and report each metric's spread, the
numbers a bound is set from.

    python3 h100_bench/spread.py --workload chain.ont --seconds 20 \
        --seeds 11 12 13 14 15 16 --sets 2 [--trace 0] [--out runs.jsonl]

Each set runs the cell once per seed, one run after another, each a
process of its own; with --sets 2 the second set repeats the first's
seeds.  For every metric and set it prints the median, the quartiles
(Python's `statistics.quantiles(values, n=4)`) and the spread, the
distance between the quartiles as a share of the median, and the
spread with the run farthest from the median left out; over the sets,
the widest spread and the mean of the trimmed ones.  It checks that
every run was correct.  --out keeps every run's result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    """(median, q1, q3, (q3 - q1) / median)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / med


def trimmed(values):
    """The spread with the value farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])[3]


def one(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(RUN), "--workload", workload,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], capture_output=True,
                       text=True)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "{}"
    res = json.loads(line) if p.returncode == 0 else {}
    res.update(rc=p.returncode, seed=seed, wall_s=time.perf_counter() - t0,
               batch_s=[float(ln.split()[-2]) for ln in p.stderr.splitlines()
                        if ln.startswith("batch of input")],
               setup=[ln for ln in p.stderr.splitlines()
                      if ln.startswith(("set-up:", "reference:"))])
    if p.returncode != 0 or not res.get("correct"):
        res["stderr_tail"] = p.stderr[-2000:]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100_bench/spread.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            r = one(args.workload, seed, args.seconds, args.trace)
            r["set"] = s
            runs.append(r)
            print(json.dumps({k: r.get(k) for k in (
                "set", "seed", "rc", "correct", "wall_s", "metrics",
                "checks", "batch_s", "setup", "stderr_tail")}), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
    names = sorted({m for r in runs for m in r.get("metrics", {})})
    for s in range(args.sets):
        for m in names:
            v = [r["metrics"][m]["value"] for r in runs
                 if r["set"] == s and m in r.get("metrics", {})]
            if len(v) >= 2:
                med, q1, q3, sp = spread(v)
                print(json.dumps(dict(workload=args.workload, set=s,
                                      metric=m, n=len(v), median=med, q1=q1,
                                      q3=q3, spread=sp,
                                      trimmed=trimmed(v) if len(v) >= 3
                                      else None, values=v)))
    for m in names:
        sets = [[r["metrics"][m]["value"] for r in runs
                 if r["set"] == s and m in r.get("metrics", {})]
                for s in range(args.sets)]
        sets = [v for v in sets if len(v) >= 3]
        if sets:
            print(json.dumps(dict(
                workload=args.workload, metric=m,
                widest=max(spread(v)[3] for v in sets),
                mean_trimmed=statistics.mean(trimmed(v) for v in sets),
                all_runs=spread([x for v in sets for x in v])[3])))
    bad = [r["seed"] for r in runs if r["rc"] != 0 or not r.get("correct")]
    print(json.dumps(dict(workload=args.workload, runs=len(runs),
                          not_correct=bad)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
