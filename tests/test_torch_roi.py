"""The port's spans and counts (`core/roi.py`), on the CPU: the ring,
the nesting, and the phases of `chain_batch` and `fast_chain_batch`,
whose counts and seconds are those of the same call's `stats=`."""

import ast
import io
import json
import pathlib
import threading

import pytest
import torch

from genarchbench_tpu_torch.core import roi
from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.kernels import chain, fast_chain
from tests.torch_chain_inputs import deferral_text, skip_break_text, tie_text

REPO = pathlib.Path(__file__).resolve().parent.parent

PHASES = ("starts", "plan", "h2d", "dp", "wait", "d2h", "unpack")
# (module, entry, the root's phases, the spans inside `.dp`, the counts)
ENTRIES = {
    "chain": (chain, chain.chain_batch, PHASES + ("scalar",), ("loop",),
              ("records", "plans", "deferred")),
    "fast_chain": (fast_chain, fast_chain.fast_chain_batch, PHASES,
                   ("far", "near"), ("plans",)),
}
# the `stats=` seconds, each the sum of its spans
LAPPED = {
    "chain": {"prep_s": ("starts", "plan", "unpack"), "h2d_s": ("h2d",),
              "loop_s": ("dp", "wait"), "d2h_s": ("d2h",),
              "scalar_s": ("scalar",)},
    "fast_chain": {"prep_s": ("starts", "plan", "unpack"),
                   "h2d_s": ("h2d",), "far_s": ("far",),
                   "near_s": ("near", "wait"), "d2h_s": ("d2h",)},
}
STATS_KEYS = {
    "chain": {"prep_s", "h2d_s", "loop_s", "d2h_s", "scalar_s", "plans",
              "widths", "steps", "deferred"},
    "fast_chain": {"prep_s", "h2d_s", "far_s", "near_s", "d2h_s", "plans",
                   "tiles", "far_chunks", "near_steps"},
}
# (entry, input, records a plan): one plan, or one plan of every two
# records
CASES = [("chain", "skip-break", None), ("chain", "deferral", None),
         ("chain", "deferral", 2), ("fast_chain", "ties", None),
         ("fast_chain", "skip-break", 2)]
TEXTS = {"skip-break": skip_break_text, "deferral": deferral_text,
         "ties": tie_text}


def read(text):
    return list(chain_io.read_records(io.StringIO(text)))


def traced(fn, *args, **kwargs):
    """(fn's result, the records it appended)."""
    _, before = roi.records()
    out = fn(*args, **kwargs)
    recs, after = roi.records()
    return out, recs[len(recs) - (after - before):]


def by_kind(recs):
    return ([r for r in recs if isinstance(r, roi.Span)],
            [r for r in recs if isinstance(r, roi.Count)])


@pytest.mark.parametrize("key,text,per_plan", CASES)
def test_a_call_is_one_root_tiled_by_its_phases(monkeypatch, key, text,
                                                per_plan):
    module, entry, phases, inner, counted = ENTRIES[key]
    if per_plan:
        monkeypatch.setattr(module, "MAX_BATCH", per_plan)
    records = read(TEXTS[text]())
    stats = {}
    _, recs = traced(entry, records, device="cpu", stats=stats)
    assert set(stats) == STATS_KEYS[key]
    spans, counts = by_kind(recs)
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == [f"{key}.batch"]
    root = roots[0]
    assert root.root == root.id
    byid = {s.id: s for s in spans}
    for s in spans:
        assert s.root == root.id
        if s is not root:
            up = byid[s.parent]
            assert up.t0 <= s.t0 <= s.t1 <= up.t1
    children = sorted((s for s in spans if s.parent == root.id),
                      key=lambda s: s.t0)
    assert {s.name for s in children} == {f"{key}.{p}" for p in phases}
    for a, b in zip(children, children[1:]):
        assert a.t1 <= b.t0
    plans = stats["plans"]
    assert plans == (-(-len(records) // per_plan) if per_plan else 1)
    names = [s.name for s in children]
    assert names.count(f"{key}.plan") == 1 + plans
    for p in ("h2d", "dp", "wait", "d2h", "unpack"):
        assert names.count(f"{key}.{p}") == plans
    for name in inner:          # the anchor loop's spans, inside `.dp`
        found = [s for s in spans if s.name == f"{key}.{name}"]
        assert found and all(byid[s.parent].name == f"{key}.dp"
                             for s in found)
    total = {}
    for c in counts:
        assert c.root == root.id and byid[c.span].t0 <= c.t <= root.t1
        total[c.name] = total.get(c.name, 0) + c.n
    assert total == {f"{key}.{c}": len(records) if c == "records"
                     else stats[c] for c in counted}
    for lapped, names in LAPPED[key].items():
        assert stats[lapped] == pytest.approx(sum(
            s.t1 - s.t0 for s in spans
            if s.name in {f"{key}.{n}" for n in names}))
    if text == "deferral" and key == "chain":
        assert total["chain.deferred"] == 3


@pytest.mark.parametrize("key", sorted(ENTRIES))
def test_counts_without_stats_are_those_with(key):
    _, entry, _, _, _ = ENTRIES[key]
    records = read(skip_break_text())

    def counted(**kwargs):
        _, recs = traced(entry, records, device="cpu", **kwargs)
        out = {}
        for c in by_kind(recs)[1]:
            out[c.name] = out.get(c.name, 0) + c.n
        return out

    stats = {}
    assert counted() == counted(stats=stats)
    assert stats["plans"] >= 1


def test_the_ring_keeps_the_newest_records():
    rec = roi.Recorder(size=8)
    for i in range(7):
        with rec.span(f"s{i}"):
            rec.count("n", i)
    kept, total = rec.records()
    assert total == 14 and len(kept) == 8
    # the newest eight, in the order they closed or were counted
    assert [r.name for r in kept] == ["n", "s3", "n", "s4", "n", "s5",
                                      "n", "s6"]
    assert [r.n for r in kept if isinstance(r, roi.Count)] == [3, 4, 5, 6]
    kept[0] = None                      # a copy
    assert rec.records()[0][0] is not None


def test_spans_nest_per_thread_and_lap_at_exit():
    rec = roi.Recorder()
    stats = {}
    lap = roi.Laps(stats, torch.device("cpu"))
    rec.count("outside", 1)
    with rec.span("a"):
        with rec.span("b", lap, "b_s"):
            assert stats == {}
            rec.count("k", 2)
        assert set(stats) == {"b_s"}
        seen = []

        def other():
            with rec.span("c") as c:
                seen.append((c.parent, c.root, c.id))

        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert not t.is_alive()
    kept, total = rec.records()
    assert total == 5
    out, k, b, c, a = kept
    assert (out.span, out.root) == (0, 0)
    assert (a.parent, a.root) == (0, a.id)
    assert (b.name, b.parent, b.root) == ("b", a.id, a.id)
    assert (k.span, k.root, k.n) == (b.id, a.id, 2)
    # the lap's seconds are the span's own
    assert stats["b_s"] == b.t1 - b.t0
    # a span opened in another thread is a root of its own
    assert seen == [(0, c.id, c.id)] and c.name == "c"


def test_spans_land_in_the_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    records = read(deferral_text())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        chain.chain_batch(records, device="cpu")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {f"chain.{p}" for p in PHASES + ("batch", "scalar", "loop")} \
        <= names


def test_only_roi_opens_record_function():
    """Every span of the port goes through `core/roi.py::span`."""
    calls = []
    for path in sorted((REPO / "genarchbench_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute) and \
                    node.attr == "record_function":
                calls.append(str(path.relative_to(REPO)))
    assert calls == ["genarchbench_tpu_torch/core/roi.py"]
