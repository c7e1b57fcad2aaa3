"""The control of `correct`: the plain reference put in the program's
place, with the gap cost one precision below the configuration's
(`control_precision`: float32 for chain's float64, bfloat16 for
fast-chain's float32).  It has to come out as not correct.

    python3 h100_bench/control.py --workload chain.ont --seeds 1 2 3

For each seed it makes the cell's inputs and checked records as a run
does (`harness/window.py`, `harness/check.py`; on the card where there
is one, as a run makes them), solves them at both precisions and
prints, as a JSON line, how many checked records differ: what
`mismatched_records` reads with the control in the program's place,
counting each distinct input once (a run counts every batch of it, so it
reads more).  The line also gives the traffic's shape: records and
anchors of the inputs, the mean window (window cells an anchor), the
longest checked record, and how many checked anchors the skip rule
stopped early (`skip_breaks`, chain only).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def readings(cell, seed: int, precision: str, device: str = "cpu"
             ) -> dict:
    from h100_bench.harness import check
    batches = cell.generator().batches(
        cell.traffic, seed, range(int(cell.traffic["batches"])), device)
    subs = {k: b.subset(check.sample(seed, k, len(b),
                                     cell.traffic["check_records"]))
            for k, b in enumerate(batches)}
    reference = cell.reference()
    work = [reference.work(b, cell.config) for b in batches]
    del batches
    n_out = len(cell.config["outputs"])
    ref = cell.reference_path()
    counts = {}
    want = check.solve_all(ref, subs, cell.config, cell.config["precision"],
                           counts)
    got = check.solve_all(ref, subs, cell.config, precision)
    anchors = sum(w["anchors"] for w in work)
    return {"workload": cell.name, "seed": seed, "precision": precision,
            "checked_records": sum(len(s) for s in subs.values()),
            "mismatched_records": sum(check.mismatched(got[k], want[k], n_out)
                                      for k in subs),
            "records": sum(w["records"] for w in work),
            "anchors": anchors,
            "anchors_max": max(int(b.n.max()) for b in subs.values()),
            "mean_window": sum(w["cells"] for w in work) / anchors,
            "checked_anchors": counts["anchors"],
            "skip_breaks": counts.get("skip_breaks", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="h100_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    repo = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))
    from h100_bench.harness.cell import load_cell
    cell = load_cell(args.workload, repo)
    import torch
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(cell, seed, cell.config["control_precision"], device)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
