"""The `wfa` configuration and its cell `wfa.pairs-96`: the pair
generator, the Gotoh reference and the wavefront count, the cell's files
found by name, whole runs on the CPU at a small size (correct, and not
correct with the timed path broken), and the wfa metric readers on
synthetic runs; one small cell on the card."""

import json
import subprocess
import sys
import time
import types
from itertools import product

import numpy as np
import pytest

from conftest import add_cell
from h100_bench.generators import pairs
from h100_bench.generators.pairs import PairBatch
from h100_bench.harness.cell import BENCH_DIR, REPO, load_cell, load_module
from h100_bench.harness.spans import RECORDER
from h100_bench.harness.trace import TraceSummary
from h100_bench.harness.window import Run, execute

SEED = 2**31 + 19
CELL = "wfa.pairs-96"
TRAFFIC = json.loads((BENCH_DIR / "traffic" / "pairs-96.json").read_text())
CONFIG = json.loads((BENCH_DIR / "configs" / "wfa.json").read_text())
reference = load_module(BENCH_DIR / "reference" / "wfa.py")
adapter = load_module(BENCH_DIR / "adapters" / "wfa.py")
METRICS = ["wfa_prep_span_share", "wfa_copy_span_share",
           "wfa_forward_span_share", "wfa_backtrace_span_share",
           "wfa_cigar_span_share", "wfa_score_steps", "wfa_resumes",
           "wfa_launches_per_step", "wfa_roofline", "wfa_window_mfu"]


def test_the_generator_is_deterministic_by_seed():
    a = pairs.batches(TRAFFIC, SEED, [0, 1])
    b = pairs.batches(TRAFFIC, SEED, [1])[0]
    c = pairs.batches(TRAFFIC, SEED + 1, [1])[0]
    assert len(a[0]) == len(b) == TRAFFIC["pairs"] == CONFIG["batch_pairs"]
    for f in ("n", "p_offs", "t_offs", "pat", "txt"):
        assert np.array_equal(getattr(a[1], f), getattr(b, f))
    assert not np.array_equal(a[0].pat, b.pat)
    assert not np.array_equal(c.pat, b.pat)
    assert (np.diff(b.p_offs) == TRAFFIC["length"]).all()
    assert (b.n == 1).all() and b.pat.max() <= 3 and b.txt.max() <= 3


def test_the_generator_follows_the_error_model():
    """Counts over many pairs: of one-base patterns, texts of two bases
    (an insertion, the pattern's base first) one in three errors, texts
    of one other base (a substitution by another base, or a deletion
    of a base other than A, whose empty text becomes "A") three in four
    of two in three; of 96-base patterns, length changes of variance
    96 * 2/3 * error_rate, no change on average."""
    err = 0.3
    b = pairs.batches(dict(TRAFFIC, pairs=200000, length=1, error_rate=err),
                      SEED, [0])[0]
    tl = np.diff(b.t_offs)
    two = tl == 2
    assert set(tl.tolist()) == {1, 2}
    assert two.mean() == pytest.approx(err / 3, abs=0.004)
    assert (b.txt[b.t_offs[:-1][two]] == b.pat[two]).all()
    one = ~two
    changed = b.txt[b.t_offs[:-1][one]] != b.pat[one]
    assert changed.sum() / len(tl) == pytest.approx(err / 2, abs=0.004)
    assert np.bincount(b.pat, minlength=4) / len(b.pat) == \
        pytest.approx([0.25] * 4, abs=0.004)
    b = pairs.batches(dict(TRAFFIC, pairs=20000), SEED, [0])[0]
    d = np.diff(b.t_offs) - 96
    assert d.mean() == pytest.approx(0, abs=0.06)
    assert d.var() == pytest.approx(96 * 2 / 3 * 0.1, rel=0.05)


def test_subset_takes_the_pairs_in_order():
    b = pairs.batches(dict(TRAFFIC, pairs=50), SEED, [0])[0]
    idx = np.array([7, 3, 49, 0])
    s = b.subset(idx)
    for k, r in enumerate(idx):
        assert np.array_equal(s.patterns()[k], b.patterns()[r])
        assert np.array_equal(s.texts()[k], b.texts()[r])
    assert len(s) == 4


def brute(p, t, x, o, e, band=None):
    """Gotoh's three matrices cell by cell, the band as a mask."""
    INF = 10 ** 9
    n, m = len(p), len(t)
    H = [[INF] * (m + 1) for _ in range(n + 1)]
    E = [[INF] * (m + 1) for _ in range(n + 1)]
    F = [[INF] * (m + 1) for _ in range(n + 1)]
    H[0][0] = 0
    for i, j in product(range(n + 1), range(m + 1)):
        if (i, j) == (0, 0) or (band is not None and abs(i - j) > band):
            continue
        if i:
            E[i][j] = min(H[i - 1][j] + o + e, E[i - 1][j] + e)
        if j:
            F[i][j] = min(H[i][j - 1] + o + e, F[i][j - 1] + e)
        d = H[i - 1][j - 1] + (p[i - 1] != t[j - 1]) * x if i and j else INF
        H[i][j] = min(d, E[i][j], F[i][j])
    return min(H[n][m], reference.INF)


def tiny_batch(rng, count, most):
    ps = [rng.integers(0, 4, rng.integers(0, most + 1)).astype(np.uint8)
          for _ in range(count)]
    ts = [rng.integers(0, 4, rng.integers(0, most + 1)).astype(np.uint8)
          for _ in range(count)]
    offs = [np.concatenate([[0], np.cumsum([len(a) for a in s])])
            for s in (ps, ts)]
    return PairBatch(np.ones(count, np.int64), offs[0], offs[1],
                     np.concatenate(ps), np.concatenate(ts)), ps, ts


@pytest.mark.parametrize("pen", [(4, 6, 2), (3, 0, 1), (1, 9, 3)])
@pytest.mark.parametrize("band", [None, 0, 2])
def test_the_reference_equals_a_brute_force_dp(pen, band):
    rng = np.random.default_rng([SEED, *pen, 99 if band is None else band])
    batch, ps, ts = tiny_batch(rng, 120, 7)
    got = reference.scores(batch, *pen, band=band)
    want = [brute(p.tolist(), t.tolist(), *pen, band)
            for p, t in zip(ps, ts)]
    assert got.tolist() == want
    precision = "exact" if band is None else f"band-{band}"
    cfg = dict(CONFIG, x=pen[0], o=pen[1], e=pen[2])
    counts = {}
    answers = reference.solve(batch, cfg, precision, counts=counts)
    assert [a[0].tolist() for a in answers] == [[w] for w in want]
    assert counts == {"anchors": len(batch.pat) + len(batch.txt)}


def test_the_wavefront_offsets_of_the_defaults():
    """x 4, o 6, e 2: M[0] one offset; M[4] from M[0] by a mismatch,
    -1..1; M, I and D[8] from M[4] and M[0], -2..2; I and D[10] from
    I and D[8] and M[6] (none), with M from them, -3..3."""
    cum = reference.wavefront_offsets(10, 4, 6, 2)
    assert cum.tolist() == [1, 1, 1, 1, 4, 4, 4, 4, 19, 19, 40]


def test_the_work_of_a_batch():
    b = pairs.batches(dict(TRAFFIC, pairs=64), SEED, [0])[0]
    w = reference.work(b, CONFIG)
    s = reference.scores(b, 4, 6, 2)
    cum = reference.wavefront_offsets(int(s.max()), 4, 6, 2)
    assert w["records"] == 64 and w["anchors"] == len(b.pat) + len(b.txt)
    assert w["cells"] == int((np.diff(b.p_offs) * np.diff(b.t_offs)).sum())
    assert w["wf_cells"] == int(cum[s].sum())
    assert w["wfa_bound_s"] == max(w["wf_cells"] * 10 / 1.67e13,
                                   (w["anchors"] + 4 * 64) / 3.35e12)


def test_the_work_leaves_the_dp_to_its_first_read(monkeypatch):
    """The set-up counts the work; the whole DP of `wf_cells` and
    `wfa_bound_s` runs once, when a reader first asks."""
    b = pairs.batches(dict(TRAFFIC, pairs=16), SEED, [0])[0]
    calls = []
    scores = reference.scores
    monkeypatch.setattr(reference, "scores",
                        lambda *a: calls.append(a) or scores(*a))
    w = reference.work(b, CONFIG)
    assert sorted(w) == ["anchors", "cells", "records"] and not calls
    assert w["wfa_bound_s"] > 0 and w["wf_cells"] > 0 and len(calls) == 1
    with pytest.raises(KeyError):
        w["bound_s"]


@pytest.mark.parametrize("cigar,want", [
    ("1M1X1M2I", 14), ("1M1X1M1I1I", 14), ("1M1D1I1M2I", 26),
    ("3M2I", -1), ("1M1X1M1I", -1), ("1M1X1M3I", -1), ("1M1X1M2D", -1),
    ("2M1X2I", -1), ("0M1M1X1M2I", -1), ("1M1X1M2I ", -1),
    ("1=1X1M2I", -1)])
def test_a_cigar_scores_as_an_alignment(cigar, want):
    """Pattern ACG against text AGGTT, x 4, o 6, e 2."""
    assert adapter.cigar_score(cigar, bytes([0, 1, 2]),
                               bytes([0, 2, 2, 3, 3]), 4, 6, 2) == want


def test_load_cell_finds_every_file():
    cell = load_cell(CELL)
    assert cell.config_name == "wfa" and cell.traffic_name == "pairs-96"
    assert cell.chips == 1
    assert cell.entry().__qualname__ == "wfa_batch"
    assert cell.reference().PRECISION == cell.config["precision"]
    assert cell.generator().__name__ == "h100_bench.generators.pairs"
    assert hasattr(cell.adapter(), "inputs") and hasattr(cell.adapter(), "run")
    assert [m["name"] for m in cell.per_layer] == METRICS
    for m in cell.per_layer + cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)


@pytest.fixture
def tiny(bench_copy):
    """A small `pairs-96` cell, every pair checked."""
    return add_cell(bench_copy, "wfa", "tiny", "pairs-96", pairs=48,
                    check_records=48)


def run_cell(repo, name, trace=False):
    return execute(load_cell(name, repo), SEED, 0.3, trace, "cpu",
                   time.perf_counter(), log=open("/dev/null", "w"))


def test_a_small_cell_runs_correct(bench_copy, tiny):
    run, res = run_cell(bench_copy, tiny, trace=True)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] == 48 * len(run.window)
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    assert run.stats["chunks"] == 1 and run.stats["score_steps"] > 0
    _, res = run_cell(bench_copy, tiny)
    assert set(res["metrics"]) == {"dp_cups", "setup_s"}


def altered(cigars):
    """The first CIGAR that ends in matches, its last match made a
    deletion and an insertion: a valid alignment, not an optimal one."""
    out = list(cigars)
    k = next(k for k, c in enumerate(out) if c.endswith("M"))
    head, n = out[k].rstrip("0123456789M"), out[k][:-1]
    n = int(n[len(head):])
    out[k] = head + (f"{n - 1}M" if n > 1 else "") + "1D1I"
    return out


FAULTS = {"an altered CIGAR": altered,
          "an empty CIGAR": lambda c: [""] + c[1:],
          "half the batch left out": lambda c: c[:len(c) // 2]
          + [""] * (len(c) - len(c) // 2)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(bench_copy, tiny, monkeypatch,
                                            fault):
    cell = load_cell(tiny, bench_copy)
    ad = cell.adapter()
    entry = ad.run

    def broken(function, inputs, device, stats=None):
        res = entry(function, inputs, device, stats)
        return ad.Answers(FAULTS[fault](res.cigars), inputs)

    monkeypatch.setattr(ad, "run", broken)
    _, res = execute(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     log=open("/dev/null", "w"))
    assert res["correct"] is False
    assert res["checks"]["mismatched_records"]["value"] > 0
    if fault != "an altered CIGAR":
        assert res["checks"]["missing_records"]["value"] > 0


def test_the_control_is_not_correct(bench_copy, tiny):
    """The band of `control_precision` on a batch of 1,024 pairs: some
    optimal alignments leave it."""
    from h100_bench import control
    name = add_cell(bench_copy, "wfa", "control", "pairs-96", pairs=1024,
                    check_records=1024)
    cell = load_cell(name, bench_copy)
    low = control.readings(cell, SEED, cell.config["control_precision"])
    assert low["mismatched_records"] > 0
    assert control.readings(cell, SEED, "exact")["mismatched_records"] == 0


# ---- the readers, on synthetic runs ----

class Span(types.SimpleNamespace):
    pass


def span(i, parent, root, name, t0, t1):
    return Span(id=i, parent=parent, root=root, name=name, t0=t0, t1=t1)


def count(sid, root, name, n, t):
    return types.SimpleNamespace(span=sid, root=root, name=name, n=n, t=t)


# one batch of two chunks: its phases in order, (name, seconds)
PHASES = [("prep", 0.02), ("prep", 0.01), ("h2d", 0.002), ("forward", 0.4),
          ("backtrace", 0.05), ("d2h", 0.003), ("cigars", 0.015),
          ("prep", 0.01), ("h2d", 0.002), ("forward", 0.4),
          ("backtrace", 0.05), ("d2h", 0.003), ("cigars", 0.015)]
WINDOW = [(1, 10.0, 11.0), (0, 11.0, 12.0)]
WANT = {"wfa_prep_span_share": 4.0, "wfa_copy_span_share": 1.0,
        "wfa_forward_span_share": 80.0, "wfa_backtrace_span_share": 10.0,
        "wfa_cigar_span_share": 3.0, "wfa_score_steps": 240.0,
        "wfa_resumes": 1.0, "wfa_launches_per_step": 230.5,
        "wfa_roofline": 0.005, "wfa_window_mfu": 0.002}


def ring(with_root=True):
    ids = iter(range(1, 10 ** 6))
    out = []
    for t in (5.0, 10.0, 11.0, 12.5):      # the warm batch, two, stats=
        root = next(ids)
        at = t + 0.001
        for k, (name, dur) in enumerate(PHASES):
            sid = next(ids)
            if with_root:
                out.append(span(sid, root, root, f"wfa.{name}", at, at + dur))
            elif name in ("forward", "backtrace", "cigars"):
                out.append(span(sid, 0, sid, f"wfa.{name}", at, at + dur))
            at += dur
        if with_root:
            for n, r in ((120, 1), (120, 0)):
                out += [count(root, root, "wfa.score_steps", n, at),
                        count(root, root, "wfa.resumes", r, at)]
            out.append(span(root, 0, root, "wfa.batch", t, at + 0.001))
    return out


def synthetic(trace=True):
    cell = types.SimpleNamespace(config=CONFIG)
    summary = TraceSummary(wall_s=1.2, busy_s=0.2, kernel_s=0.19,
                           launches=55320, device_ops=[], idle_gaps=[])
    work = [{"wfa_bound_s": 0.19 * 0.005 / 100},
            {"wfa_bound_s": 0.0000305}]
    return Run(cell=cell, setup_s=15.0, window=list(WINDOW), work=work,
               stats={"score_steps": 240} if trace else None,
               trace=summary if trace else None)


def read(name, run):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(run)


@pytest.mark.parametrize("name", METRICS)
def test_the_readers_read_a_run(monkeypatch, name):
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(
        records=lambda: (ring(), len(ring()))))
    assert read(name, synthetic()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", METRICS)
def test_the_readers_find_nothing_to_read(monkeypatch, name):
    """Without a trace and stats= (but the window's share of the peak);
    in another configuration's run, whose work counts no `wfa_bound_s`
    (but the launches, which any configuration's spans give); and, for
    the program's spans and counts, without a recorder, or with the
    spans of a program that keeps no `wfa.batch` root (each phase a root
    of its own)."""
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(
        records=lambda: (ring(), len(ring()))))
    if name != "wfa_window_mfu":
        assert read(name, synthetic(trace=False)) is None
    other = synthetic()
    other.work = [{"bound_s": 1e-5}, {"bound_s": 1e-5}]
    if name in ("wfa_window_mfu", "wfa_roofline"):
        assert read(name, other) is None
    if name.startswith(("wfa_launches", "wfa_roofline", "wfa_window")):
        return
    monkeypatch.delitem(sys.modules, RECORDER)
    assert read(name, synthetic()) is None
    flat = ring(with_root=False)
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(
        records=lambda: (flat, len(flat))))
    assert read(name, synthetic()) is None


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_wfa_cell_on_the_card(card, bench_copy, tiny, trace):
    b = json.loads((bench_copy / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in METRICS:
            m["workloads"].append(tiny)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(b))
    (bench_copy / "genarchbench_tpu_torch").symlink_to(
        REPO / "genarchbench_tpu_torch")
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", tiny,
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=bench_copy)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["kind"] == card
    if trace:
        assert set(res["metrics"]) == set(METRICS)
        shares = sum(res["metrics"][m]["value"] for m in METRICS[:5])
        assert 90 <= shares <= 100
    else:
        assert set(res["metrics"]) == {"dp_cups", "setup_s"}
