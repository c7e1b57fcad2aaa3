"""The readers of the program's spans and counts (`harness/spans.py`):
on a synthetic run whose window holds synthetic records, the shares
and counts, their denominator (the window's batches alone), and nothing
to read without a recorder, with a ring that lost part of the window,
or without device activity; then on a whole traced run of each
configuration on the CPU."""

import dataclasses
import sys
import time
import types
from typing import NamedTuple

import pytest

from h100_bench.harness.cell import BENCH_DIR, load_cell, load_module
from h100_bench.harness.spans import RECORDER
from h100_bench.harness.trace import TraceSummary
from h100_bench.harness.window import Run, execute


class Span(NamedTuple):         # the program's records, field for field
    id: int
    parent: int
    root: int
    name: str
    t0: float
    t1: float


class Count(NamedTuple):
    span: int
    root: int
    name: str
    n: int
    t: float


# one batch: its phases in order, (name, seconds); its counts
PHASES = [("starts", 0.1), ("plan", 0.4), ("h2d", 0.2), ("dp", 0.1),
          ("wait", 0.05), ("d2h", 0.15), ("unpack", 0.1), ("scalar", 0.8)]
WINDOW = [(1, 10.0, 12.0), (0, 12.0, 14.0)]
# the warm batch before the window, the stats= and profiled batches after
OUTSIDE = [5.0, 14.5, 16.5]
# over the window's 4 s: two batches of PHASES, 100 records each, all
# deferred, in 2 plans each
WANT = {"prep_span_share": 30.0, "copy_span_share": 17.5,
        "scalar_span_share": 40.0, "dp_span_share": 5.0,
        "wait_span_share": 2.5, "deferred_share": 100.0,
        "plans_per_batch": 2.0}


def batch(ids, t, plans, deferred, scale=1.0):
    """The records of one chain batch starting at t: a root, its phases
    back to back from t + 0.01, the anchor loop inside `.dp`."""
    root = next(ids)
    out = [Count(root, root, "chain.records", 100, t)]
    at = t + 0.01
    for name, dur in PHASES:
        sid = next(ids)
        dur *= scale
        if name == "plan":
            out.append(Count(sid, root, "chain.plans", plans, at))
        if name == "scalar":
            out.append(Count(sid, root, "chain.deferred", deferred, at))
        if name == "dp":
            out.append(Span(next(ids), sid, root, "chain.loop", at, at + dur))
        out.append(Span(sid, root, root, f"chain.{name}", at, at + dur))
        at += dur
    out.append(Span(root, 0, root, "chain.batch", t, at + 0.01))
    return out


def ring(scale_outside=1.0):
    ids = iter(range(1, 10 ** 6))
    recs = batch(ids, OUTSIDE[0], 7, 0, scale_outside)
    for _, t, _ in WINDOW:
        recs += batch(ids, t, 2, 100)
    for t in OUTSIDE[1:]:
        recs += batch(ids, t, 7, 0, scale_outside)
    return recs


def recorder(recs, total=None):
    return types.SimpleNamespace(
        records=lambda: (list(recs), len(recs) if total is None else total))


def run(busy_s=0.25, trace=True):
    summary = TraceSummary(wall_s=2.0, busy_s=busy_s, kernel_s=0.1,
                           launches=0, device_ops=[], idle_gaps=[])
    return Run(cell=None, setup_s=1.0, window=list(WINDOW), work=[],
               trace=summary if trace else None)


def read(name, r):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name", sorted(WANT))
def test_the_readers_read_the_window(monkeypatch, name):
    monkeypatch.setitem(sys.modules, RECORDER, recorder(ring()))
    assert read(name, run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_the_denominator_is_the_window_batches_only(monkeypatch, name):
    """The warm, stats= and profiled batches, three times as long, move
    nothing; nor does a ring that lost records of the warm batch alone."""
    recs = ring(scale_outside=3.0)
    monkeypatch.setitem(sys.modules, RECORDER, recorder(recs))
    assert read(name, run()) == pytest.approx(WANT[name])
    lost = recs[5:]
    monkeypatch.setitem(sys.modules, RECORDER,
                        recorder(lost, total=len(recs)))
    assert read(name, run()) == pytest.approx(WANT[name])


NOTHING = {
    "no recorder": lambda: (None, run()),
    "a recorder without a ring (an older program)":
        lambda: (types.SimpleNamespace(), run()),
    "a ring that lost part of the window":
        lambda: (recorder(ring()[40:], total=len(ring())), run()),
    "no root span inside the window":
        lambda: (recorder([r for r in ring() if not (
            isinstance(r, Span) and r.parent == 0 and 10.0 <= r.t0 < 14.0)]),
            run()),
    "a trace without device activity": lambda: (recorder(ring()), run(0.0)),
    "no trace": lambda: (recorder(ring()), run(trace=False)),
}


@pytest.mark.parametrize("case", sorted(NOTHING))
@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_to_read(monkeypatch, name, case):
    module, r = NOTHING[case]()
    if module is None:
        monkeypatch.delitem(sys.modules, RECORDER, raising=False)
    else:
        monkeypatch.setitem(sys.modules, RECORDER, module)
    assert read(name, r) is None


SHARES = {"chain": ["prep_span_share", "copy_span_share", "dp_span_share",
                    "wait_span_share", "scalar_span_share"],
          "fast-chain": ["prep_span_share", "copy_span_share",
                         "dp_span_share", "wait_span_share"]}


@pytest.mark.parametrize("config", sorted(SHARES))
def test_a_traced_run_of_the_program(bench_copy, config):
    """The program's own records of a small traced run on the CPU, read
    as if its trace had shown device activity: the shares nearly tile
    the window, every record of `ont` is deferred on chain, and the
    window's batches ran one plan each."""
    cell = load_cell(f"{config}.tiny", bench_copy)
    r, res = execute(cell, 2**31 + 11, 0.5, True, "cpu",
                     time.perf_counter(), log=open("/dev/null", "w"))
    assert res["correct"] is True
    r = dataclasses.replace(r, trace=dataclasses.replace(r.trace,
                                                         busy_s=1e-3))
    shares = [read(n, r) for n in SHARES[config]]
    assert all(0 <= s <= 100 for s in shares)
    assert 80 < sum(shares) <= 100
    assert read("plans_per_batch", r) == 1.0
    if config == "chain":
        assert read("deferred_share", r) == 100.0
    else:
        assert read("deferred_share", r) is None
