"""The `bsw` configuration and its cell `bsw.bwamem2`: the generator of
seed extensions, the reference against a scalar DP written out cell by
cell, the work and its lazy bound, the cell's files found by name, whole
runs on the CPU at a small size (correct, and not correct with the timed
path broken or the control in its place), and the bsw metric readers on
synthetic runs; one small cell on the card."""

import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from conftest import add_cell
from h100_bench.generators import extensions
from h100_bench.generators.extensions import ExtensionBatch
from h100_bench.harness.cell import BENCH_DIR, REPO, load_cell, load_module
from h100_bench.harness.spans import RECORDER
from h100_bench.harness.trace import TraceSummary
from h100_bench.harness.window import Run, execute

SEED = 2**31 + 23
CELL = "bsw.bwamem2"
TRAFFIC = json.loads((BENCH_DIR / "traffic" / "bwamem2.json").read_text())
CONFIG = json.loads((BENCH_DIR / "configs" / "bsw.json").read_text())
reference = load_module(BENCH_DIR / "reference" / "bsw.py")
METRICS = ["bsw_prep_span_share", "bsw_copy_span_share",
           "bsw_kernel_span_share", "bsw_roofline"]
SMALL = dict(contigs=[300000, 200000], pairs=600, slice_pairs=512)


def small(seed=SEED, ks=(0,), **changes):
    return extensions.batches(dict(TRAFFIC, **dict(SMALL, **changes)), seed,
                              ks)


# ---- the generator ----

def test_the_generator_is_deterministic_by_seed():
    a = small(ks=(0, 1))
    b = small(ks=(1,))[0]
    c = small(SEED + 1, ks=(1,))[0]
    for f in ("n", "h0", "r_offs", "q_offs", "ref", "qry"):
        assert np.array_equal(getattr(a[1], f), getattr(b, f))
    assert not np.array_equal(a[0].qry, b.qry)
    assert not np.array_equal(c.qry, b.qry)
    assert b.pairs == 600 and b.n.tolist() == [512, 88] and len(b) == 2
    assert b.ref.max() <= 3 and b.qry.max() <= 3
    full = extensions.batches(TRAFFIC, SEED, [0])[0]
    assert full.pairs == CONFIG["pairs"] == TRAFFIC["pairs"]
    assert (full.n == CONFIG["batch_size"]).all()


def test_targets_keep_the_cal_max_gap_relation():
    """Each target is qlen + cal_max_gap(qlen) long but where a contig
    ends first; cal_max_gap is min(max(qlen - 5, 1), 200) at bwa's
    defaults; queries are 1-131 bases, h0 the seed's length, 19-149."""
    b = small(pairs=4000)[0]
    q, t = np.diff(b.q_offs), np.diff(b.r_offs)
    gap = extensions.cal_max_gap(TRAFFIC, q)
    assert gap.tolist() == np.minimum(np.maximum(q - 5, 1), 200).tolist()
    assert (t <= q + gap).all() and (t == q + gap).mean() > 0.99
    assert q.min() >= 1 and q.max() <= 150 - 19
    assert b.h0.min() >= 19 and b.h0.max() <= 149


def test_the_extensions_of_each_read_against_its_seed():
    """The pairs of one round, rebuilt read by read with plain loops from
    the same reads: the seed is the first longest run of clean bases
    that follow one another in the reference, it matches the reference
    exactly, h0 is its length, the left extension is the read before it
    reversed against the reference before it reversed, the right one the
    rest of the read against the reference after it."""
    t = dict(TRAFFIC, **SMALL)
    genome = extensions._genome(t, SEED)
    reads, tix, clean, origin, step, lo, hi = extensions._reads_of(
        np.random.default_rng(5), t, genome, 60)
    h0, tlen, tgt, qlen, qry = extensions._round(
        np.random.default_rng(5), t, genome, 60)

    def ref_at(r, k):     # template index k of read r, or None off its contig
        g = origin[r] + step[r] * k
        if not lo[r] <= g < hi[r]:
            return None
        return int(3 - genome[g] if step[r] < 0 else genome[g])

    want = []
    L = reads.shape[1]
    for r in range(len(reads)):
        best, qs = 0, 0
        for j in range(L):
            n = 0
            while (j + n < L and clean[r, j + n]
                   and (n == 0 or tix[r, j + n] == tix[r, j + n - 1] + 1)):
                n += 1
            if n > best:
                best, qs = n, j
        if best < 19:
            continue
        rs = int(tix[r, qs])
        assert [int(b) for b in reads[r, qs:qs + best]] == \
            [ref_at(r, rs + k) for k in range(best)]
        for side in (-1, 1):
            q = (reads[r, :qs][::-1] if side < 0 else reads[r, qs + best:])
            if not len(q):
                continue
            start = rs - 1 if side < 0 else rs + best
            gap = int(extensions.cal_max_gap(t, np.array([len(q)]))[0])
            tg = [ref_at(r, start + side * k) for k in range(len(q) + gap)]
            tg = tg[:tg.index(None)] if None in tg else tg
            want.append((best, q.tolist(), tg))
    qo = np.concatenate([[0], np.cumsum(qlen)])
    to = np.concatenate([[0], np.cumsum(tlen)])
    got = [(int(h0[p]), qry[qo[p]:qo[p + 1]].tolist(),
            tgt[to[p]:to[p + 1]].tolist()) for p in range(len(h0))]
    assert got == want and len(got) > 100


def test_the_haplotype_and_the_errors_follow_wgsim():
    """Over 20,000 reads at a raised mutation rate: read bases in error
    or mutated about rate x 2/3 x 0.85 + 0.02, inserted bases about rate
    x 2/3 x 0.15 x 0.5 x E[min(geometric(0.7), 4)], deleted template
    bases about as many with E[geometric(0.7)] a deletion."""
    rate = 0.03
    t = dict(TRAFFIC, **dict(SMALL, mutation_rate=rate))
    genome = extensions._genome(t, SEED)
    reads, tix, clean, *_ = extensions._reads_of(
        np.random.default_rng(9), t, genome, 10000)
    n = reads.size
    indels = rate * 2 / 3 * 0.15 * 0.5
    ins = (tix == -1).sum() / n
    assert ins == pytest.approx(indels * (1 + 0.3 + 0.09 + 0.027), rel=0.15)
    jumps = np.diff(np.where(tix >= 0, tix, 0), axis=1)
    kept = (tix[:, 1:] >= 0) & (tix[:, :-1] >= 0)
    deleted = (jumps[kept] - 1).sum() / n
    assert deleted == pytest.approx(indels / 0.7, rel=0.15)
    dirty = (~clean & (tix >= 0)).sum() / n
    assert dirty == pytest.approx(rate * 2 / 3 * 0.85 + 0.02, rel=0.05)


def test_a_traffic_without_extensions_is_refused():
    with pytest.raises(ValueError):
        small(error_rate=0.0, mutation_rate=0.0)


def test_subset_takes_whole_slices_in_order():
    b = small()[0]
    s = b.subset(np.array([1, 0]))
    assert s.n.tolist() == [88, 512] and s.pairs == 600
    order = list(range(512, 600)) + list(range(512))
    for got, want in ((s.targets(), b.targets()), (s.queries(), b.queries())):
        assert all(np.array_equal(g, want[p]) for g, p in zip(got, order))
    assert s.h0.tolist() == b.h0[order].tolist()


# ---- the reference ----

def brute(t, q, h0, c, N=4):
    """One pair alone (a group of one lane) cell by cell: the band, its
    narrowing, the head and tail, the z-drop and the stops written out
    as the scalar loops they stand for."""
    qlen, tlen, w = len(q), len(t), c["w"]
    oe_ins, oe_del = c["o_ins"] + c["e_ins"], c["o_del"] + c["e_del"]

    def limit(o, e):
        v = (qlen * c["match"] + c["end_bonus"] - o) % 65536
        return max(int(v / e + 1.0), 1)

    band = min(w, limit(c["o_ins"], c["e_ins"]), limit(c["o_del"], c["e_del"]))
    H = [h0 if j == 0 else max(h0 - oe_ins - (j - 1) * c["e_ins"], 0)
         for j in range(qlen)] + [0]
    F = [0] * (qlen + 1)
    head, tail, live = 0, qlen, True
    best = h0
    x = y = 0
    nbeg, nend = 0, qlen
    mlen = min(qlen + band, tlen)
    for i in range(tlen):
        beg, end = max(nbeg, i - w), min(nend, i + w + 1, qlen)
        old = head, tail
        head, tail = max(head, i - band), min(tail, i + 1 + band, qlen)
        if (head, tail) != old:
            for j in range(beg, min(end, head)):
                if head > j or j + 1 > tail:
                    H[j] = F[j] = 0
        if i + 1 > mlen or tail <= head:
            live = False
        h10 = max(h0 - c["o_del"] - (i + 1) * c["e_del"], 0) if beg == 0 \
            else 0
        e, hprev, row_best, y1 = 0, h10, 0, 0
        for j in range(beg, end):
            if t[i] == N or q[j] == N:
                s = c["ambig"]
            else:
                s = c["match"] if t[i] == q[j] else -c["mismatch"]
            m = 0 if H[j] == 0 else H[j] + s
            h = max(m, e, F[j])
            f = max(m - oe_del, 0, F[j] - c["e_del"])
            outside = head > j or j > tail
            H[j] = 0 if outside else hprev
            F[j] = 0 if outside else f
            hprev = h
            e = max(m - oe_ins, 0, e - c["e_ins"])
            if j < tail and h >= row_best:
                row_best, y1 = h, j + 1
        H[end] = hprev
        F[end] = 0
        if row_best == 0:
            break
        if live and row_best > best:
            best, x, y = row_best, i + 1, y1
        if (best - row_best) - abs((i + 1 - x) - (y1 - y)) > c["zdrop"]:
            live = False
        nonzero = [F[j] != 0 or H[j] != 0 for j in range(beg, end + 1)]
        first = next((beg + k for k, v in enumerate(nonzero[:-1]) if v), end)
        if first > beg:
            nbeg = first - 1
        last = max((beg + k for k, v in enumerate(nonzero) if v),
                   default=beg - 1)
        nend = min(last + 2, qlen)
        if live:
            if first > beg:
                head = first
            pick = last
        else:
            pick = end
        tail = min((pick if end - pick >= 1 else tail) + 2, qlen)
    return best


def random_batch(rng, count, most_t, most_q, ambiguous=0.0, size=64):
    """Random pairs, most of them alike over their first bases (a tenth
    substituted), a third with a stretch of random bases inside a match
    (a drop, then a climb back), a fifth whose query lies 7-12 bases off
    the diagonal, some with homopolymer halves; an N in `ambiguous` of
    the bases."""
    ts = [rng.integers(0, 4, rng.integers(0, most_t + 1)).astype(np.uint8)
          for _ in range(count)]
    qs = [rng.integers(0, 4, rng.integers(1, most_q + 1)).astype(np.uint8)
          for _ in range(count)]
    for s in ts + qs:
        if len(s) and rng.random() < 0.2:
            s[len(s) // 2:] = s[0]
    for p in range(count):
        k = min(len(ts[p]), len(qs[p]))
        u = rng.random()
        if u < 0.6:
            ts[p][:k] = qs[p][:k]
            flip = rng.random(k) < 0.1
            ts[p][:k][flip] = (ts[p][:k][flip] + 1) % 4
        if u < 0.3 and k > 12:
            a = int(rng.integers(3, k // 2))
            qs[p][a:a + int(rng.integers(3, 7))] = rng.integers(0, 4)
        elif u > 0.8:      # the query after a few target bases: off the
            d = int(rng.integers(7, 13))     # diagonal by more than w
            ts[p] = np.concatenate([ts[p][:d], qs[p]])[:most_t]
    for s in ts + qs:
        s[rng.random(len(s)) < ambiguous] = 4
    offs = [np.concatenate([[0], np.cumsum([len(a) for a in s])])
            for s in (ts, qs)]
    n = np.diff(np.append(np.arange(0, count, size), count))
    return ExtensionBatch(n, rng.integers(0, 60, count).astype(np.int32),
                          offs[0], offs[1], np.concatenate(ts),
                          np.concatenate(qs)), ts, qs


# (scoring, its keys narrow enough to change some scores of random_batch)
SCORINGS = [(dict(), ()), (dict(w=6), ("w",)),
            (dict(match=2, mismatch=3, ambig=-2, o_del=4, e_del=2, o_ins=3,
                  e_ins=1, zdrop=6, end_bonus=2), ("zdrop",)),
            (dict(match=3, mismatch=2, o_del=3, e_del=2, o_ins=2, e_ins=2), ())]


@pytest.mark.parametrize("k", range(len(SCORINGS)))
def test_the_reference_equals_a_scalar_dp_for_groups_of_one(k):
    """Equal scores; where the scoring narrows the z-drop or the band,
    the scalar DP without that narrowing differs on some pairs (so the
    inputs exercise it)."""
    rng = np.random.default_rng([SEED, k])
    batch, ts, qs = random_batch(rng, 300, 40, 30, ambiguous=0.03)
    scoring, narrow = SCORINGS[k]
    cfg = dict(CONFIG, lanes=1, batch_size=64, **scoring)
    got = np.concatenate([a[0] for a in reference.solve(batch, cfg)])
    cases = list(zip(ts, qs, batch.h0.tolist()))
    want = [brute(t.tolist(), q.tolist(), h, cfg) for t, q, h in cases]
    assert got.tolist() == want
    assert len(set(want)) > 20
    for key in narrow:
        wide = dict(cfg, **{key: 1000})
        assert sum(brute(t.tolist(), q.tolist(), h, wide) != v
                   for (t, q, h), v in zip(cases, want)) >= 3, key


def test_groups_follow_the_counting_sort():
    """Each slice's pairs by target length, ties in input order, the
    padding (-1, an empty pair) first, eight to a group."""
    rng = np.random.default_rng(3)
    batch, ts, _ = random_batch(rng, 75, 20, 10, size=64)
    g = reference.groups(batch, dict(CONFIG, batch_size=64))
    assert g.shape == (8 + 2, 8)
    for part, pairs in ((g[:8].ravel(), range(64)), (g[8:].ravel(),
                                                    range(64, 75))):
        key = [(len(ts[p]) if p >= 0 else 0, p < 0, max(p, 0))
               for p in part]
        assert key == sorted(key)
        assert sorted(p for p in part if p >= 0) == list(pairs)
    assert (g < 0).sum() == 5
    with pytest.raises(ValueError):
        reference.groups(batch, dict(CONFIG, batch_size=32))


def test_the_control_saturates():
    b = small()[0]
    exact, _ = reference.extend(b, CONFIG)
    low, _ = reference.extend(b, CONFIG, "int8")
    assert exact.max() > 127 and low.max() == 127
    assert (low != exact).sum() > 100


def test_the_work_of_a_batch():
    b = small()[0]
    w = reference.work(b, CONFIG)
    q, t = np.diff(b.q_offs), np.diff(b.r_offs)
    assert w["records"] == 2 and w["pairs"] == 600
    assert w["anchors"] == len(b.ref) + len(b.qry) == int((q + t).sum())
    assert w["cells"] == int((np.minimum(201, q) * t).sum())
    _, band = reference.extend(b, CONFIG)
    assert w["band_cells"] == band
    assert 0.5 * w["cells"] < band < w["cells"]
    assert w["bsw_bound_s"] == max(band * 24 / 1.67e13,
                                   (w["anchors"] + 40 * 600) / 3.35e12)


def test_the_work_leaves_the_dp_to_its_first_read(monkeypatch):
    b = small(pairs=40)[0]
    calls = []
    extend = reference.extend
    monkeypatch.setattr(reference, "extend",
                        lambda *a: calls.append(a) or extend(*a))
    w = reference.work(b, CONFIG)
    assert sorted(w) == ["anchors", "cells", "pairs", "records"] and not calls
    assert w["bsw_bound_s"] > 0 and w["band_cells"] > 0 and len(calls) == 1
    with pytest.raises(KeyError):
        w["wfa_bound_s"]


# ---- the cell ----

def test_load_cell_finds_every_file():
    cell = load_cell(CELL)
    assert cell.config_name == "bsw" and cell.traffic_name == "bwamem2"
    assert cell.chips == 1
    assert cell.entry().__qualname__ == "bsw_batch"
    assert cell.reference().PRECISION == cell.config["precision"]
    assert cell.config["control_precision"] in cell.reference().SATURATE
    assert cell.generator().__name__ == "h100_bench.generators.extensions"
    assert cell.traffic["slice_pairs"] == cell.config["batch_size"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    for m in cell.per_layer + cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)


@pytest.fixture
def tiny(bench_copy):
    """A small `bwamem2` cell: 600 pairs in two slices, both checked."""
    return add_cell(bench_copy, "bsw", "tiny", "bwamem2", **SMALL,
                    check_records=2)


def run_cell(repo, name, trace=False):
    return execute(load_cell(name, repo), SEED, 0.3, trace, "cpu",
                   time.perf_counter(), log=open("/dev/null", "w"))


def test_a_small_cell_runs_correct(bench_copy, tiny):
    run, res = run_cell(bench_copy, tiny, trace=True)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] == 2 * len(run.window)
    assert all(c == {"value": 0, "limit": 0} for c in res["checks"].values())
    _, res = run_cell(bench_copy, tiny)
    assert set(res["metrics"]) == {"dp_cups", "setup_s"}


def altered(scores):
    out = scores.copy()
    out[7] += 1
    return out


FAULTS = {"an altered score": altered,
          "a missing answer": lambda s: s[:-1],
          "half the batch left out": lambda s: s[:len(s) // 2]}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(bench_copy, tiny, monkeypatch,
                                            fault):
    cell = load_cell(tiny, bench_copy)
    ad = cell.adapter()
    entry = ad.run

    def broken(function, inputs, device, stats=None):
        res = entry(function, inputs, device, stats)
        return ad.Answers(FAULTS[fault](res.scores), inputs.slices)

    monkeypatch.setattr(ad, "run", broken)
    _, res = execute(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     log=open("/dev/null", "w"))
    assert res["correct"] is False
    assert res["checks"]["mismatched_records"]["value"] > 0
    if fault != "an altered score":
        assert res["checks"]["missing_records"]["value"] > 0


def test_the_control_is_not_correct(bench_copy, tiny):
    from h100_bench import control
    cell = load_cell(tiny, bench_copy)
    low = control.readings(cell, SEED, cell.config["control_precision"])
    assert low["mismatched_records"] == low["checked_records"] == 4
    assert control.readings(cell, SEED, "exact")["mismatched_records"] == 0


# ---- the readers, on synthetic runs ----

def span(i, parent, root, name, t0, t1):
    return types.SimpleNamespace(id=i, parent=parent, root=root, name=name,
                                 t0=t0, t1=t1)


def count(sid, root, name, n, t):
    return types.SimpleNamespace(span=sid, root=root, name=name, n=n, t=t)


PHASES = [("prep", 0.9), ("h2d", 0.03), ("kernel", 0.05), ("d2h", 0.01)]
WINDOW = [(1, 10.0, 11.0), (0, 11.0, 12.0)]
WANT = {"bsw_prep_span_share": 90.0, "bsw_copy_span_share": 4.0,
        "bsw_kernel_span_share": 5.0, "bsw_roofline": 8.0}


WFA_PHASES = [("prep", 0.4), ("h2d", 0.03), ("forward", 0.05),
              ("backtrace", 0.01), ("d2h", 0.01), ("cigars", 0.4)]


def ring(root_name="bsw.batch", prefix="bsw", phases=PHASES):
    ids = iter(range(1, 10 ** 6))
    out = []
    for t in (5.0, 10.0, 11.0, 12.5):      # the warm batch, two, stats=
        root = next(ids)
        at = t + 0.001
        for name, dur in phases:
            out.append(span(next(ids), root, root, f"{prefix}.{name}", at,
                            at + dur))
            at += dur
        out += [count(root, root, f"{prefix}.pairs", 16384, at),
                count(root, root, f"{prefix}.groups", 2048, at)]
        out.append(span(root, 0, root, root_name, t, at + 0.001))
    return out


def synthetic(trace=True):
    cell = types.SimpleNamespace(config=CONFIG)
    summary = TraceSummary(wall_s=1.0, busy_s=0.002, kernel_s=0.0015,
                           launches=4, device_ops=[], idle_gaps=[])
    work = [{"bsw_bound_s": 0.0015 * 0.08}, {"bsw_bound_s": 0.00011}]
    return Run(cell=cell, setup_s=20.0, window=list(WINDOW), work=work,
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
    """Without a trace; in another configuration's run (work without
    `bsw_bound_s`, spans of a `wfa.batch` root); without a recorder;
    and with the spans of a program that keeps no `bsw.batch` root
    (the parent's bsw_batch records none)."""
    monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(
        records=lambda: (ring(), len(ring()))))
    assert read(name, synthetic(trace=False)) is None
    other = synthetic()
    other.work = [{"wfa_bound_s": 1e-5}, {"bound_s": 1e-5}]
    if name == "bsw_roofline":
        assert read(name, other) is None
        return
    monkeypatch.delitem(sys.modules, RECORDER)
    assert read(name, synthetic()) is None
    for recs in ([r for r in ring() if not r.name.startswith("bsw")],
                 ring("wfa.batch", "wfa", WFA_PHASES)):
        monkeypatch.setitem(sys.modules, RECORDER, types.SimpleNamespace(
            records=lambda recs=recs: (recs, len(recs))))
        assert read(name, synthetic()) is None


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_bsw_cell_on_the_card(card, bench_copy, tiny, trace):
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
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["kind"] == card
    if trace:
        assert set(res["metrics"]) == set(METRICS)
        shares = sum(res["metrics"][m]["value"] for m in METRICS[:3])
        assert 95 <= shares <= 100
        assert 0 < res["metrics"]["bsw_roofline"]["value"] < 100
    else:
        assert set(res["metrics"]) == {"dp_cups", "setup_s"}
