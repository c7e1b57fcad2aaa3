"""Chain-format inputs for the port's chain and fast-chain checks
(tests/test_torch_chain*.py, chip_smoke.py): numpy only, each text
built to reach one path or hazard of the kernels."""

import numpy as np

SPAN15 = np.uint64(15) << np.uint64(32)     # q_span 15 in y's bits 32-39


def chain_text(records):
    """Chain-format text of (avg, mdx, mdy, bw, n_segs, x, y) tuples."""
    out = []
    for avg, mdx, mdy, bw, nsegs, x, y in records:
        out.append(f"{len(x)} {avg} {mdx} {mdy} {bw} {nsegs}\n")
        out.extend(f"{int(a)} {int(b)}\n" for a, b in zip(x, y))
        out.append("EOR\n")
    return "".join(out)


def straddling_x(rng, lo, n):
    """Sorted uint64 anchors stepping across `lo` (a low-word boundary)."""
    return (np.uint64(lo) - np.uint64(2000)
            + np.cumsum(rng.integers(1, 120, n)).astype(np.uint64))


def skip_break_text():
    """tests/test_chain.py's stress input: dense low-score runs in front
    of each high-score anchor drive n_skip past MAX_SKIP before the true
    best predecessor is reached, so the break changes the result."""
    recs = []
    for rec in range(6):
        xs, qs = [], []
        for k in range(1, 11):
            qa0 = 1000 * k - 500 - 200 * (k % 2)
            xa0 = 1000 * k - 100 - rec
            for j in range(35):
                xs.append(xa0 + 2 * j)
                qs.append(qa0 + 2 * j)
            xs.append(1000 * k)
            qs.append(1000 * k)
        recs.append((23.5, 5000, 5000, 5000, 1, xs,
                     SPAN15 | np.array(qs, np.uint64)))
    return chain_text(recs)


def tie_text():
    """Anchors with two predecessors of equal score (j1 = (a, b), j2 =
    (a + 20, b), anchor (a + 110, b + 100): dd = 10 from both, and j2
    does not chain from j1 as dq = 0), so the largest j must win.  The
    triplets sit at anchors 126-128 (both in fast-chain's far pass of
    tile 1) and 254-256 (j1 far, j2 near), between blockers whose q
    is out of every window's reach."""
    xs, qs = [], []

    def blockers(count, q0):
        x0 = xs[-1] + 10 if xs else 0
        xs.extend(x0 + 10 * np.arange(count))
        qs.extend(q0 + 10 * np.arange(count))

    def triplet(a, b):
        xs.extend([a, a + 20, a + 110])
        qs.extend([b, b, b + 100])

    blockers(126, 10**6)
    triplet(xs[-1] + 1000, 1000)
    blockers(125, 2 * 10**6)
    triplet(xs[-1] + 1000, 3000)
    blockers(40, 3 * 10**6)
    y = SPAN15 | np.array(qs, np.uint64)
    return chain_text([(23.5, 5000, 5000, 500, 1, xs, y),
                       (33.5, 5000, 5000, 500, 1, xs[100:300], y[100:300])])


def empty_single_text(gen_chain_input):
    """Three short records from tests/synth.py's `gen_chain_input`, then a
    record of no anchor and one of a single anchor."""
    text = gen_chain_input(np.random.default_rng(7), n_records=3,
                           max_anchors=2)
    return text + chain_text([(20.5, 5000, 5000, 500, 1, [], []),
                              (12.0, 5000, 5000, 500, 1, [40],
                               [(15 << 32) | 9])])


def deferral_text():
    """avg_qspan 450 and 600.25 (their products pass SAFE_PROD) and
    104.487175 (more than CORR_K corrections) beside records that stay
    on the device."""
    rng = np.random.default_rng(21)
    recs = []
    for avg in (23.5, 450.0, 33.5, 104.487175, 17.0, 600.25):
        n = int(rng.integers(50, 200))
        x = np.cumsum(rng.integers(1, 150, n)).astype(np.uint64)
        q = np.cumsum(rng.integers(1, 150, n)).astype(np.uint64)
        recs.append((avg, 5000, 5000, 500, 1, x, SPAN15 | q))
    return chain_text(recs)


def dense_text():
    """Records whose every anchor lies in one window (x spread under
    max_dist_x), so the plan's window is as wide as its padded length."""
    rng = np.random.default_rng(22)
    recs = []
    for n in (63, 40, 57, 62):
        x = 100 + np.cumsum(rng.integers(0, 70, n)).astype(np.uint64)
        q = 50 + np.cumsum(rng.integers(0, 60, n)).astype(np.uint64)
        sid = rng.integers(0, 2, n).astype(np.uint64) << np.uint64(48)
        recs.append((float(np.float32(rng.uniform(10, 40))), 5000, 3000,
                     500, 2, x, SPAN15 | sid | q))
    return chain_text(recs)


def wrap_text():
    """x low words straddling 2^31 and 2^32 inside a window, so the
    int32 difference of the low words must wrap like the C's uint32."""
    rng = np.random.default_rng(23)
    recs = []
    for lo in (2**31, 2**32, 2**31, 2**32):
        n = 80
        q = np.cumsum(rng.integers(1, 120, n)).astype(np.uint64)
        recs.append((17.0, 5000, 5000, 500, 1, straddling_x(rng, lo, n),
                     SPAN15 | q))
    return chain_text(recs)


def boundary_text():
    """dd = 40 at avg_qspan 27.5: 40 * 0.01f = 0.39999998f, times 27.5f
    is 10.999999f, which truncates to 10 (a rounding convert gives 11)."""
    x = [1000, 1140, 1300, 1440]
    q = [1000, 1100, 1220, 1320]
    return chain_text([(27.5, 5000, 5000, 500, 1, x,
                        SPAN15 | np.array(q, np.uint64))])


def clz_text():
    """Consecutive anchors at dd = 2^k - 1 and 2^k for k = 1..30 (dq 1..20
    apart), under max_dist_x = max_dist_y = bw = 2^31 - 1 so no test
    masks them, and avg_qspan 0, whose gap cost needs no correction."""
    rng = np.random.default_rng(24)
    big = 2**31 - 1
    recs = []
    for r in range(3):
        ks = np.repeat(np.arange(1, 31), 2)
        dd = (1 << ks) - (np.arange(len(ks)) + r) % 2
        dq = rng.integers(1, 21, len(ks))
        x = np.concatenate([[5], 5 + np.cumsum(dd + dq)]).astype(np.uint64)
        q = np.concatenate([[0], np.cumsum(dq)]).astype(np.uint64)
        recs.append((0.0, big, big, big, 1, x, SPAN15 | q))
    return chain_text(recs)


def sr_like_text(rng, count):
    """Records shaped like `-x sr` pairs: two mates of 150 bases 350
    apart, each a few tens of k = 21 anchors (segment 0, then 1), the
    query the two mates end to end, max_dist_x 500, max_dist_y 300, bw
    100; now and then a record of no anchor."""
    recs = []
    for _ in range(count):
        m = rng.integers(0, 20, 2) * (rng.random() > 0.02)
        pos = int(rng.integers(0, 4_000_000))
        x, q, sid = [], [], []
        for s, k in enumerate(m):
            off = np.sort(rng.choice(130, int(k), replace=False))
            x.append(pos + 350 * s + off)
            q.append(150 * s + off + rng.integers(0, 3, int(k)))
            sid.append(np.full(int(k), s))
        x, q, sid = (np.concatenate(a).astype(np.uint64) for a in (x, q, sid))
        recs.append((21.0, 500, 300, 100, 2, (np.uint64(1) << np.uint64(32))
                     | x, (sid << np.uint64(48)) | (np.uint64(21) <<
                                                    np.uint64(32)) | q))
    return chain_text(recs)


def ont_like_text(rng, count):
    """Records shaped like `-x map-ont` reads: hundreds to a few thousand
    anchors about 12 bases apart, max_dist_x = max_dist_y = 5000, bw 500,
    avg_qspan 15 (deferred by chain) or drawn in [10, 40)."""
    recs = []
    for _ in range(count):
        n = int(rng.integers(200, 3000))
        x = 10**6 + np.cumsum(rng.integers(0, 25, n)).astype(np.uint64)
        q = np.cumsum(rng.integers(0, 25, n)).astype(np.uint64)
        avg = 15.0 if rng.random() < 0.5 else \
            float(np.float32(rng.uniform(10, 40)))
        recs.append((avg, 5000, 5000, 500, 1, x, SPAN15 | q))
    return chain_text(recs)
