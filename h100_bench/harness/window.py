"""One run of one cell: set-up, the measured window, the traced batches
and the check, as the result line's fields.

Set-up runs from the process's start to the first timed batch: imports,
the device's context, the native build on a checkout's first run, the
traffic's input batches (made from the seed, on the run's device) and
one warm batch.  The
window is a closed loop: one batch at a time, back to back, each
synchronised at its end, cycling through the distinct inputs (from the
second, so that no input is timed right after the warm batch) until
`seconds` have passed; the batch running at the deadline completes and
counts.  With `trace`, one batch of input 0 then runs with the program's
`stats=` (which synchronises at each phase boundary) and one more under
torch.profiler.  Every batch's answers are checked once all that is
done (see `check`).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import torch

from h100_bench.harness import check, roofline
from h100_bench.harness.cell import Cell
from h100_bench.harness.trace import TraceSummary, summarize

WINDOW_SPAN = "h100_bench.batch"
TRACED_INPUT = 0


@dataclasses.dataclass
class Run:
    """What the metric readers read (`metrics/<name>.py::read`)."""
    cell: Cell
    setup_s: float
    window: List[Tuple[int, float, float]]   # (input, start, end) a batch
    work: List[dict]        # per input: records, anchors, cells, bound_s
    stats: Optional[dict] = None          # the program's stats= of a batch
    stats_wall_s: Optional[float] = None  # that batch's wall seconds
    trace: Optional[TraceSummary] = None  # the profiled batch

    @property
    def window_s(self) -> float:
        """From the window's start to its last batch's completion."""
        return self.window[-1][2] - self.window[0][1]

    def window_sum(self, key: str) -> float:
        """`key` of the work, summed over the window's batches."""
        return sum(self.work[k][key] for k, _, _ in self.window)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(run_batch, inputs, dev: torch.device, spans):
    """One batch under torch.profiler: (its answers, the summary)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            res = run_batch(inputs, dev)
            _sync(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return res, summarize(events, WINDOW_SPAN, spans)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t0: float, log=sys.stderr) -> Tuple[Run, dict]:
    """Run the cell once; returns (the run, the result line's fields)."""
    cfg, traffic = cell.config, cell.traffic
    marks = [("imports", time.perf_counter())]
    adapter, reference = cell.adapter(), cell.reference()
    entry = cell.entry()

    def run_batch(inputs, dev, stats=None):
        return adapter.run(entry, inputs, dev, stats)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    marks.append(("device", time.perf_counter()))
    batches = cell.generator().batches(traffic, seed,
                                       range(int(traffic["batches"])), dev)
    if dev.type == "cuda":
        # the inputs are made on the card: the peak is the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    inputs = [adapter.inputs(b) for b in batches]
    work = []
    for b in batches:
        w = reference.work(b, cfg)
        w["bound_s"] = roofline.bound_s(w["cells"], w["anchors"], cfg)
        work.append(w)
    marks.append(("inputs", time.perf_counter()))
    outputs = [(0, run_batch(inputs[0], dev))]             # warm
    _sync(dev)
    marks.append(("warm batch", time.perf_counter()))
    # the inputs live as long as the run: keep them out of the window's
    # garbage collections
    gc.collect()
    gc.freeze()
    run = Run(cell, time.perf_counter() - t0, [], work)

    k = 1
    start = time.perf_counter()
    while True:
        i = k % len(inputs)
        b0 = time.perf_counter()
        res = run_batch(inputs[i], dev)
        _sync(dev)
        b1 = time.perf_counter()
        run.window.append((i, b0, b1))
        outputs.append((i, res))
        gc.freeze()     # the kept answers, too, out of later collections
        k += 1
        if b1 - start >= seconds:
            break

    if trace:
        run.stats = {}
        s0 = time.perf_counter()
        outputs.append((TRACED_INPUT, run_batch(
            inputs[TRACED_INPUT], dev, stats=run.stats)))
        _sync(dev)
        run.stats_wall_s = time.perf_counter() - s0
        res, run.trace = _profile(run_batch, inputs[TRACED_INPUT], dev,
                                  cfg["spans"])
        outputs.append((TRACED_INPUT, res))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b)
        in zip([("", t0)] + marks, marks)), file=log)
    for i, b0, b1 in run.window:
        print(f"batch of input {i}: {b1 - b0:.6f} s", file=log)
    if run.stats is not None:
        print(f"stats of input {TRACED_INPUT}: {json.dumps(run.stats)} in "
              f"{run.stats_wall_s:.6f} s", file=log)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, after the window, with the program's device state freed
    n_out = len(cfg["outputs"])
    lost = [check.missing(res, batches[i].n, n_out) for i, res in outputs]
    idx = {i: check.sample(seed, i, len(batches[i]), traffic["check_records"])
           for i in {i for i, _ in outputs}}
    got = [(i, check.pick(res, idx[i], n_out)) for i, res in outputs]
    del outputs, res, inputs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    want = check.solve_all(cell.reference_path(),
                           {i: batches[i].subset(s) for i, s in idx.items()},
                           cfg, cfg["precision"])
    print(f"reference: {time.perf_counter() - r0:.3f} s for "
          f"{sum(len(s) for s in idx.values())} records of "
          f"{len(idx)} inputs", file=log)
    checks = {
        "mismatched_records": sum(check.mismatched(g, want[i], n_out)
                                  for i, g in got),
        "missing_records": sum(lost),
    }
    correct = all(checks[n] <= lim for n, lim in check.LIMITS.items())

    result = {
        "correct": correct,
        "attempted": int(run.window_sum("records")),
        "failed": int(sum(lost[1:1 + len(run.window)])),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.wall_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in run.trace.device_ops],
            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["checks"] = {n: {"value": v, "limit": check.LIMITS[n]}
                        for n, v in checks.items()}
    return run, result
