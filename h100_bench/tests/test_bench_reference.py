"""The plain references against hand-worked records and against scalar
loops written here from the reference's C (GenArchBench
benchmarks/chain/src/host_kernel.cpp:30-94 and
benchmarks/fast-chain/src/host_kernel.cpp:803-866), on records made
here: a skip break, a u32 wrap, ties, and gap costs whose float32 and
float64 truncations differ (the records the program defers to its
scalar C DP among them)."""

import numpy as np
import pytest

from h100_bench.generators.batch import AnchorBatch
from h100_bench.harness.cell import BENCH_DIR, load_module
from h100_bench.reference import _anchors

CHAIN = load_module(BENCH_DIR / "reference" / "chain.py")
FAST = load_module(BENCH_DIR / "reference" / "fast-chain.py")
CONFIG = {"max_chain_iter": 5000, "max_chain_skip": 25}


def batch(records):
    """An AnchorBatch of (avg, mdx, mdy, bw, n_segs, x, q[, span, sid])."""
    n = np.array([len(r[5]) for r in records], np.int64)
    offs = np.zeros(len(n) + 1, np.int64)
    np.cumsum(n, out=offs[1:])
    xs, ys = [], []
    for r in records:
        span = r[7] if len(r) > 7 else 15
        sid = r[8] if len(r) > 8 else [0] * len(r[5])
        xs.append(np.array(r[5], np.uint64))
        ys.append((np.array(sid, np.uint64) << np.uint64(48))
                  | (np.uint64(span) << np.uint64(32))
                  | np.array(r[6], np.uint64))
    col = [np.array([r[c] for r in records], np.int64) for c in range(1, 5)]
    return AnchorBatch(n, offs, np.array([r[0] for r in records], np.float32),
                       *col, np.concatenate(xs), np.concatenate(ys))


def i32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def log2(dd):
    return (dd & 0xFFFFFFFF).bit_length() - 1 if dd else 0


def scalar_chain(b, r, max_skip=25, precision="f64"):
    """chain_dp of record r, one anchor and one predecessor at a time."""
    o, n = int(b.offs[r]), int(b.n[r])
    x = [int(v) for v in b.x[o:o + n]]
    y = [int(v) for v in b.y[o:o + n]]
    avg = np.float32(b.avg_qspan[r])
    mdx, mdy, bw = int(b.max_dist_x[r]), int(b.max_dist_y[r]), int(b.bw[r])
    multi = int(b.n_segs[r]) > 1
    f, p, v, t = [0] * n, [-1] * n, [0] * n, [-1] * n
    st = 0
    for i in range(n):
        while st < i and x[i] > x[st] + mdx:
            st += 1
        lo = max(st, i - CONFIG["max_chain_iter"])
        span_i = (y[i] >> 32) & 0xFF
        sid_i = (y[i] >> 48) & 0xFF
        max_f, max_j, n_skip = span_i, -1, 0
        for j in range(i - 1, lo - 1, -1):
            dr = i32(x[i] - x[j])
            dq = i32((y[i] & 0xFFFFFFFF) - (y[j] & 0xFFFFFFFF))
            seq = sid_i == (y[j] >> 48) & 0xFF
            if (seq and dr == 0) or dq <= 0:
                continue
            if (seq and dq > mdy) or dq > mdx:
                continue
            dd = abs(dr - dq)
            if seq and dd > bw:
                continue
            if multi and seq and dr > mdy:
                continue
            lin = int(_anchors.linear_gap(np.array([dd], np.int32),
                                          avg, precision)[0])
            bonus = 0
            if seq:
                gap = lin + (log2(dd) >> 1)
            elif dr == 0:
                gap, bonus = 0, 1
            else:
                gap = min(lin, log2(dd))
            sc = min(dq, dr, span_i) + bonus - gap + f[j]
            if sc > max_f:
                max_f, max_j = sc, j
                n_skip = max(n_skip - 1, 0)
            elif t[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if p[j] >= 0:
                t[p[j]] = i
        f[i], p[i] = max_f, max_j
        v[i] = v[max_j] if max_j >= 0 and v[max_j] > max_f else max_f
    return f, p, v


def scalar_fast_chain(b, r, precision="f32"):
    o, n = int(b.offs[r]), int(b.n[r])
    x = [int(v) for v in b.x[o:o + n]]
    y = [int(v) for v in b.y[o:o + n]]
    avg = np.float32(b.avg_qspan[r])
    mdxy = min(int(b.max_dist_x[r]), int(b.max_dist_y[r]))
    bw = int(b.bw[r])
    f, p = [0] * n, [-1] * n
    st = 0
    for i in range(n):
        while st < i and x[i] > x[st] + int(b.max_dist_x[r]):
            st += 1
        span_i = (y[i] >> 32) & 0xFF
        max_f, max_j = span_i, -1
        for j in range(i - 1, max(st, i - CONFIG["max_chain_iter"]) - 1, -1):
            dr = i32(x[i] - x[j])
            dq = i32((y[i] & 0xFFFFFFFF) - (y[j] & 0xFFFFFFFF))
            dd = abs(dr - dq)
            if dr == 0 or dq <= 0 or dq > mdxy or dd > bw:
                continue
            lin = int(_anchors.linear_gap(np.array([dd], np.int32),
                                          avg, precision)[0])
            sc = min(dq, dr, span_i) - (lin + (log2(dd) >> 1)) + f[j]
            if sc > max_f:
                max_f, max_j = sc, j
        f[i], p[i] = max_f, max_j
    return f, p


HAND = (15.0, 5000, 5000, 500, 1, [100, 160, 300], [50, 100, 120])


def test_a_hand_worked_record():
    """a1 from a0: dd 10, gap (int)1.5 + (3 >> 1) = 2, so 15 - 2 + 15.
    a2 from a1: dd 120, gap (int)(120 * .01 * 15) + (6 >> 1), where the
    float64 product is 18 and the float32 one 17.999999 (truncated to
    17); from a0 (dd 130) it scores 8, then t[0] == 2, a skip hit."""
    b = batch([HAND])
    s, p, v = CHAIN.solve(b, CONFIG)[0]
    assert (s.tolist(), p.tolist(), v.tolist()) == \
        ([15, 28, 22], [-1, 0, 1], [15, 28, 28])
    s32 = CHAIN.solve(b, CONFIG, "f32")[0][0]
    assert s32.tolist() == [15, 28, 23]
    s, p = FAST.solve(b, CONFIG)[0]
    assert (s.tolist(), p.tolist()) == ([15, 28, 23], [-1, 0, 1])


def skip_break():
    """A strong chain (40 anchors, 60 apart), then 40 anchors each 2 after
    the last, which cannot follow the strong chain (their q lies below
    it) and chain among themselves, then an anchor that follows the
    strong chain best but meets the dense run first, scoring low there:
    each dense anchor is the parent of the one after it, so every slot
    is a skip hit and n_skip passes 25 before the strong chain."""
    x = [1000 + 60 * k for k in range(40)]
    q = [5000 + 60 * k for k in range(40)]
    x += [x[-1] + 100 + 2 * k for k in range(40)]
    q += [3000 + 2 * k for k in range(40)]
    x.append(x[39] + 400)
    q.append(q[39] + 400)
    return (23.0, 5000, 5000, 5000, 1, x, q)


def wrap():
    """x's low word crosses 2^32 inside a window (rid 0 -> 1)."""
    x = (1 << 32) - 2000 + np.cumsum(np.arange(1, 80) * 7 % 113 + 1)
    q = 50 + np.cumsum(np.arange(1, 80) * 5 % 97 + 1)
    return (17.0, 5000, 5000, 500, 1, x.tolist(), q.tolist())


def ties():
    """Two predecessors of equal score (j1 = (a, b), j2 = (a + 20, b)):
    the anchor (a + 110, b + 100) takes the larger j."""
    return (23.0, 5000, 5000, 500, 1, [0, 1000, 1020, 1110],
            [0, 2000, 2000, 2100])


def two_segments():
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.integers(0, 70, 60)) + 100
    q = np.cumsum(rng.integers(0, 60, 60)) + 50
    sid = rng.integers(0, 2, 60)
    return (17.0, 5000, 3000, 500, 2, x.tolist(), q.tolist(), 15,
            sid.tolist())


def precision_records():
    """avg_qspan 15, 20, 40 (float32 and float64 truncations differ at dd
    multiples of 5 or 20), 104.487175 (more differences than the
    program's four corrections) and 450 and 600.25 (products past its
    bound): the program defers the last three to its scalar C DP."""
    rng = np.random.default_rng(4)
    out = []
    for avg in (15.0, 20.0, 40.0, 104.487175, 450.0, 600.25):
        x = np.cumsum(rng.integers(1, 150, 120)) + 100
        q = np.cumsum(rng.integers(1, 150, 120)) + 50
        out.append((avg, 5000, 5000, 500, 1, x.tolist(), q.tolist()))
    return out


RECORDS = {"skip-break": [skip_break()], "u32-wrap": [wrap()],
           "ties": [ties()], "two-segments": [two_segments()],
           "precision": precision_records(), "hand": [HAND]}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_chain_against_the_scalar_loop(name):
    b = batch(RECORDS[name])
    for r, got in enumerate(CHAIN.solve(b, CONFIG)):
        assert [a.tolist() for a in got] == list(scalar_chain(b, r))


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_fast_chain_against_the_scalar_loop(name):
    b = batch(RECORDS[name])
    for r, got in enumerate(FAST.solve(b, CONFIG)):
        assert [a.tolist() for a in got] == list(scalar_fast_chain(b, r))


def test_the_hazards_are_reached():
    b = batch([skip_break()])
    assert scalar_chain(b, 0) != scalar_chain(b, 0, max_skip=10**9)
    b = batch([wrap()])
    lo = b.x & np.uint64(0xFFFFFFFF)
    assert (np.diff(lo.astype(np.int64)) < 0).any()
    s, p, _ = CHAIN.solve(batch([ties()]), CONFIG)[0]
    assert p[3] == 2 and s[1] == s[2]
    b = batch(precision_records())
    f32 = CHAIN.solve(b, CONFIG, "f32")
    assert any(not np.array_equal(g[0], w[0])
               for g, w in zip(f32, CHAIN.solve(b, CONFIG)))


def test_window_cells_and_bound():
    from h100_bench.harness import roofline
    x = np.array([0, 10, 20, 30, 5000, 5010, 20000], np.uint64)
    offs = np.array([0, 4, 7], np.int64)
    mdx = np.array([25, 25], np.int64)
    # windows 0, 1, 2, 2 and 0, 1, 0 (the second record starts at 5000)
    assert _anchors.window_cells(x, offs, mdx, 5000) == 6
    assert _anchors.window_cells(x, offs, mdx, 1) == 4
    cfg = {"ops_per_cell": 44, "bytes_per_anchor": 26}
    assert roofline.bound_s(6, 7, cfg) == pytest.approx(7 * 26 / 3.35e12)
    assert roofline.bound_s(10**9, 7, cfg) == pytest.approx(44e9 / 1.67e13)


def test_window_starts_across_strands_and_contigs():
    """x with the reverse-strand bit (63) and contig words: a window never
    reaches across them, and thresholds below 0 start at the record."""
    top = np.uint64(1) << np.uint64(63)
    x = np.array([3, 40, (1 << 32) | 10, (1 << 32) | 30, 5, 20],
                 np.uint64)
    x[4:] |= top
    x = np.concatenate([x, np.array([7, 8], np.uint64) | top])
    offs = np.array([0, 6, 8], np.int64)
    mdx = np.array([25, 1], np.int64)
    st = _anchors.window_starts(x, offs, mdx, 5000)
    assert st.tolist() == [0, 1, 2, 2, 4, 4, 0, 0]
