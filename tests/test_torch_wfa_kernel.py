"""The contract of wfa's score-loop kernel (csrc/wfa.cu), on the CPU and
on the card.

On the CPU, a scalar model of the kernel's loop (one pair at a time,
its diagonals one by one as a warp's lanes take them: extension by
comparing the bases 8 bytes at a time, the adaptive reduction, the end
check, wavefront s+1 computed and extended in one pass, the store words
written there, and a chunk that runs again at twice the cap while a pair
is unfinished) is held to the torch-op loop
(`kernels/wfa.py::_forward_chunk_torch`): equal final scores and offsets,
equal store words at every diagonal [lo, hi] of every score up to a
pair's final score, and equal CIGARs from the model's store with every
other cell filled with noise.  A scalar model of the backtrace kernel's
walk (one pair at a time, as a thread takes it, reading one store word
an active step) is held to the lock-step torch walk
(`kernels/wfa.py::_wfa_backtrace`): equal records up to each pair's last
step, zeros after, and equal CIGARs, also over the model's store with
its noise, of which the walk reads no cell.  On the card (tests marked
`card`, which skip without one), both kernels are held to the same
torch-op versions run on the card.  This file imports no JAX: on the
card run it with
`python -m pytest tests/test_torch_wfa_kernel.py --noconftest -m card`.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, encode_dna
from genarchbench_tpu_torch.kernels import wfa, wfa_cuda

# tests/synth.py by path: without this directory's conftest, `tests`
# may name another installation's package
_spec = importlib.util.spec_from_file_location(
    "wfa_kernel_synth", pathlib.Path(__file__).with_name("synth.py"))
synth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(synth)

NULL, NEG, BIG = -10, -(1 << 29), 1 << 29
ABSENT = (0, 1, -1)


# ---------------------------------------------------------------------------
# the scalar model
# ---------------------------------------------------------------------------

def load8(row: bytes, pos: int) -> int:
    """row[pos .. pos+7] as a little-endian word, 0 past the row."""
    return int.from_bytes(row[pos:pos + 8].ljust(8, b"\0"), "little")


def match_run(P: bytes, v: int, T: bytes, h: int, lim: int) -> int:
    """The run of matches of P[v:] against T[h:], at most lim: the first
    set bit of the XOR of 8 bytes of each."""
    r = 0
    while r < lim:
        d = load8(P, v + r) ^ load8(T, h + r)
        if d:
            return min(r + (((d & -d).bit_length() - 1) >> 3), lim)
        r += 8
    return lim


def model_pair(P, T, pl, tl, K0, D, Scap, x, o, e, red_len, red_dist):
    """One pair's pass at geometry (K0, D) and cap Scap, as a warp runs
    it: (done, final score, final offset, steps, {(s, j): store word}
    for every diagonal j of [lo, hi] of every score s it computed)."""
    RS = max(x, o + e) + 1
    RM = RS + 1
    RI = RM if e == 0 else e + 1
    Mv = [[NULL] * D for _ in range(RM)]
    Iv = [[NULL] * D for _ in range(RI)]
    Dv = [[NULL] * D for _ in range(RI)]
    Mb, Ib, Db = [ABSENT] * RM, [ABSENT] * RI, [ABSENT] * RI

    def at(bnd, slot):
        ex, lo, hi = bnd[slot]
        return (ex, lo, hi) if ex else ABSENT

    cells = {}
    ak = tl - pl
    jak = min(max(ak + K0, 0), D - 1)
    Mb[0] = (1, 0, 0)
    run = match_run(P, 0, T, 0, min(pl, tl)) if pl > 0 and tl > 0 else 0
    Mv[0][K0] = run
    cells[(0, K0)] = run << 8
    dists = [max(pl - run, tl - run)]
    s = 0
    while True:
        tm = s % RM
        m_ex, m_lo, m_hi = at(Mb, tm)
        jlo, jhi = max(m_lo + K0, 0), min(m_hi + K0, D - 1)
        if red_len > 0 and m_ex and m_hi - m_lo + 1 >= red_len:
            dm = min(dists, default=BIG)
            kept = [j - K0 for j in range(jlo, jhi + 1)
                    if max(pl - (Mv[tm][j] - (j - K0)), tl - Mv[tm][j]) - dm
                    <= red_dist]
            mn, mx = min(kept, default=BIG), max(kept, default=-BIG)
            top = min(ak - 1, m_hi)
            first = mn if mn < top else BIG
            nlo = max(min(first, top), m_lo) if top > m_lo else m_lo
            bot = max(ak + 1, nlo)
            last = mx if mx > bot else -BIG
            nhi = min(max(last, bot), m_hi) if m_hi > bot else m_hi
            nex = int(nlo <= nhi)
            Mb[tm] = (nex, nlo, nhi)
            ti = s % RI
            for bnd in (Ib, Db):
                ex, lo, hi = at(bnd, ti)
                if ex:
                    lo, hi = max(lo, nlo), min(hi, nhi)
                bnd[ti] = (int(ex and lo <= hi), lo, hi)
            m_ex, m_lo, m_hi = nex, nlo, nhi
        if m_ex and m_lo <= ak <= m_hi:
            a = Mv[tm][jak] if jlo <= jak <= jhi else NULL
            if a >= tl:
                return True, s, a, s + 1, cells
        if s + 1 >= Scap:
            return False, 0, 0, Scap, cells

        sn = s + 1

        def src(d):
            return sn - RS if d == 0 else sn - d

        ss, sg, si = src(x), src(o + e), src(e)
        w_sub = at(Mb, ss % RM) if ss >= 0 else ABSENT
        w_gap = at(Mb, sg % RM) if sg >= 0 else ABSENT
        w_ie = at(Ib, si % RI) if si >= 0 else ABSENT
        w_de = at(Db, si % RI) if si >= 0 else ABSENT
        compute = w_sub[0] or w_gap[0] or w_ie[0] or w_de[0]
        lo = min(w_sub[1], w_gap[1], w_ie[1], w_de[1]) - 1
        hi = max(w_sub[2], w_gap[2], w_ie[2], w_de[2]) + 1
        ialloc = compute and (w_gap[0] or w_ie[0])
        dalloc = compute and (w_gap[0] or w_de[0])
        tn, tni = sn % RM, sn % RI
        dists = []
        if compute:
            Msub = Mv[ss % RM] if ss >= 0 else None
            Mgap = Mv[sg % RM] if sg >= 0 else None
            Iext = Iv[si % RI] if si >= 0 else None
            Dext = Dv[si % RI] if si >= 0 else None

            def fetch(row, w, k, j):
                """(in bounds, the value: NULL out of bounds or past the
                store's edges)."""
                inb = bool(w[0]) and w[1] <= k <= w[2]
                return inb, (row[j] if inb and 0 <= j < D else NULL)

            for j in range(max(lo + K0, 0), min(hi + K0, D - 1) + 1):
                k = j - K0
                in_s, r_s = fetch(Msub, w_sub, k, j)
                in_ig, r_ig = fetch(Mgap, w_gap, k - 1, j - 1)
                _, r_gd = fetch(Mgap, w_gap, k + 1, j + 1)
                in_ii, r_ii = fetch(Iext, w_ie, k - 1, j - 1)
                _, r_dd = fetch(Dext, w_de, k + 1, j + 1)
                ins = max(r_ig, r_ii) + 1
                dl = max(r_gd, r_dd)
                sub = NULL if r_s == NULL else r_s + 1
                msn = max(sub, ins if ialloc else NEG, dl if dalloc else NEG)
                ie_c = r_ii + 1 if in_ii else NULL
                io_c = r_ig + 1 if in_ig else NULL
                mm_c = r_s + 1 if in_s else NULL
                de_c, do_c = r_dd, r_gd
                best = max(mm_c, de_c, do_c, ie_c, io_c)
                opm = (wfa.C_DE if best == de_c else wfa.C_DO if best == do_c
                       else wfa.C_IE if best == ie_c
                       else wfa.C_IO if best == io_c else wfa.C_MM)
                code = opm | int(max(ie_c, io_c) != ie_c) << 3 \
                    | int(max(de_c, do_c) != de_c) << 4
                v = msn - k
                run = 0
                if 0 <= v < pl and 0 <= msn < tl:
                    run = match_run(P, v, T, msn, min(pl - v, tl - msn))
                ms = msn + run
                Mv[tn][j] = ms
                Iv[tni][j] = ins if ialloc else NULL
                Dv[tni][j] = dl if dalloc else NULL
                cells[(sn, j)] = code | run << 8
                dists.append(max(pl - (ms - k), tl - ms))
        Mb[tn] = (1, lo, hi) if compute else ABSENT
        Ib[tni] = (1, lo, hi) if ialloc else ABSENT
        Db[tni] = (1, lo, hi) if dalloc else ABSENT
        s = sn


def model_chunk(pat, txt, plen, tlen, scap, x, o, e, red_len=0,
                red_dist=0, seed=0):
    """The kernel's chunk (`_forward_chunk_cuda`) on the model: passes
    from score 0 at doubling caps until every pair is done.  Returns the
    `_Forward`, its store noise wherever the model wrote nothing, and
    each pair's written cells."""
    B, Lp = pat.shape
    Lt = txt.shape[1]
    K0, D = wfa._geometry(Lp, Lt, scap)
    resumes = lane_steps = 0
    while True:
        res = [model_pair(bytes(pat[b]), bytes(txt[b]), int(plen[b]),
                          int(tlen[b]), K0, D, scap, x, o, e, red_len,
                          red_dist) for b in range(B)]
        lane_steps += sum(r[3] for r in res)
        if all(r[0] for r in res):
            break
        resumes += 1
        scap *= 2
        K0, D = wfa._next_geometry(Lp, Lt, scap, K0, D)
    store = np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, (B, scap, D), dtype=np.int64).astype(np.int32)
    for b, r in enumerate(res):
        for (s, j), word in r[4].items():
            store[b, s, j] = word
    fscore = torch.tensor([r[1] for r in res], dtype=torch.int32)
    foff = torch.tensor([r[2] for r in res], dtype=torch.int32)
    fw = wfa._Forward(torch.from_numpy(store), fscore, foff, K0, scap,
                      max((r[1] for r in res), default=0),
                      max((r[3] for r in res), default=0), lane_steps,
                      resumes)
    return fw, [r[4] for r in res]


def model_walk(store, fscore, foff, plen, tlen, K0, x, o, e, T):
    """The backtrace kernel's walks, one pair at a time as a thread takes
    it: from (final score, alignment diagonal, final offset) until the
    walk finishes or takes T steps, reading one store word an active
    step.  Returns (the longest walk, nmats (B, T), ops (B, T), lanes
    (5, B): gap_t, gap_v, fm, fd, fi, and each pair's cells read as a
    set of (score, diagonal index))."""
    store = np.asarray(store)
    B, Scap, D = store.shape
    nmats = np.zeros((B, T), np.int32)
    ops = np.zeros((B, T), np.int8)
    lanes = np.zeros((5, B), np.int32)
    reads = []
    longest = 0
    for b in range(B):
        pl, tl = int(plen[b]), int(tlen[b])

        def valid_loc(j, off):
            return 0 < off - (j - K0) <= pl and 0 < off <= tl

        jak = min(max(tl - pl + K0, 0), D - 1)
        sc, j, off, bty = int(fscore[b]), jak, int(foff[b]), wfa.BT_M
        valid = valid_loc(jak, off)
        gap_t, gap_v = -1, 0
        read = set()
        t = 0
        while t < T and off - (j - K0) > 0 and off > 0 and sc > 0:
            now = valid_loc(j, off)
            if not valid and now:
                gap_t, gap_v = t, j - jak
            valid = valid or now
            cell = (min(max(sc, 0), Scap - 1), min(max(j, 0), D - 1))
            read.add(cell)
            word = int(store[(b, *cell)])
            opm, opi, opd = word & 7, (word >> 3) & 1, (word >> 4) & 1
            isM, isI, isD = bty == wfa.BT_M, bty == wfa.BT_I, bty == wfa.BT_D
            if isM:
                nmats[b, t] = word >> 8
                off -= word >> 8
            de = (isM and opm == wfa.C_DE) or (isD and opd == 0)
            do = (isM and opm == wfa.C_DO) or (isD and opd == 1)
            ie = (isM and opm == wfa.C_IE) or (isI and opi == 0)
            io = (isM and opm == wfa.C_IO) or (isI and opi == 1)
            mm = isM and opm == wfa.C_MM
            if valid:
                ops[b, t] = (wfa.OP_D if de or do else wfa.OP_I if ie or io
                             else wfa.OP_X if mm else wfa.OP_NONE)
            sc -= e if de or ie else o + e if do or io else x if mm else 0
            j += 1 if de or do else -1 if ie or io else 0
            off -= 1 if ie or io or mm else 0
            bty = (wfa.BT_D if de else wfa.BT_I if ie
                   else wfa.BT_M if do or io or mm else bty)
            t += 1
        longest = max(longest, t)
        lanes[:, b] = (gap_t, gap_v, off if sc == 0 else 0,
                       max(off - (j - K0), 0) if sc else 0,
                       max(off, 0) if sc else 0)
        reads.append(read)
    return longest, nmats, ops, lanes, reads


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def encoded(pairs):
    return [(encode_dna(a), encode_dna(b)) for a, b in pairs]


def pairs_of(seed, n, length, err):
    """n pairs of `length` random bases against the pattern mutated at
    `err` (tests/synth.py's model), encoded."""
    rng = np.random.default_rng(seed)
    pats = [synth.random_dna(rng, length) for _ in range(n)]
    return encoded([(a, synth.mutate(rng, a, err)) for a in pats])


def seqpairs(pairs):
    return SeqPairs([a for a, _ in pairs], [b for _, b in pairs])


def chunk_arrays(pairs):
    """A chunk's padded rows as `_wfa_chunk` builds them: (pat, txt, plen,
    tlen) numpy arrays."""
    P = [a for a, _ in pairs]
    T = [b for _, b in pairs]
    Lp = wfa._round_up(max(max(len(a) for a in P), 1), 32)
    Lt = wfa._round_up(max(max(len(b) for b in T), 1), 32)
    pat = np.full((len(P), Lp), 250, np.uint8)
    txt = np.full((len(T), Lt), 251, np.uint8)
    for i, (a, b) in enumerate(zip(P, T)):
        pat[i, :len(a)] = a
        txt[i, :len(b)] = b
    return (pat, txt, np.array([len(a) for a in P], np.int32),
            np.array([len(b) for b in T], np.int32))


def cigars(fw, plen, tlen, x, o, e):
    """The chunk's CIGARs from its store, as `_wfa_chunk` makes them."""
    if min(e, x) >= 1:
        max_steps = min(fw.max_score // min(e, x) + 3, fw.scap)
    else:
        max_steps = fw.scap
    res = wfa._wfa_backtrace(fw.store, fw.fscore, fw.foff, plen, tlen,
                             K0=fw.K0, x=x, o=o, e=e, max_steps=max_steps)
    return native.wfa_cigars(*[r.cpu().numpy() for r in res[1:]])


def torch_walk(fw, plen, tlen, x, o, e, T):
    """The lock-step torch walk over fw's store, at most T steps: (the
    steps it ran, nmats, ops, lanes) as numpy arrays."""
    ran, nmats, ops, *lanes = wfa._wfa_backtrace(
        fw.store, fw.fscore, fw.foff, plen, tlen, K0=fw.K0, x=x, o=o, e=e,
        max_steps=T)
    return (ran, nmats.cpu().numpy(), ops.cpu().numpy(),
            torch.stack(lanes).cpu().numpy())


def assert_walk_equal(got, want, T):
    """A kernel's (or the model's) walk `got` = (longest walk, nmats,
    ops, lanes) against the torch walk's `want`: the records equal up to
    the torch walk's steps and zero after, equal lanes, equal CIGARs,
    and the torch walk stopped at the first flag read after the longest
    walk's end."""
    longest, nmats, ops, lanes = got
    ran, w_nmats, w_ops, w_lanes = want
    assert nmats.shape == ops.shape == (lanes.shape[1], T)
    assert ran == min(wfa._round_up(longest + 1, wfa.BT_UNROLL), T)
    np.testing.assert_array_equal(nmats[:, :ran], w_nmats)
    np.testing.assert_array_equal(ops[:, :ran], w_ops)
    assert not nmats[:, ran:].any() and not ops[:, ran:].any()
    np.testing.assert_array_equal(lanes, w_lanes)
    assert native.wfa_cigars(nmats, ops, *lanes) == \
        native.wfa_cigars(w_nmats, w_ops, *w_lanes)


def cells_mask(cells, fscore, shape):
    """(B, S, D) bool: each pair's written cells of scores up to its
    final score."""
    mask = np.zeros(shape, bool)
    for b, cs in enumerate(cells):
        for s, j in cs:
            if s <= fscore[b]:
                mask[b, s, j] = True
    return torch.from_numpy(mask)


def assert_store_equal(got, want, mask, K0_got, K0_want):
    """`got` and `want` (B, S, D) stores equal at the cells of `mask` (in
    got's geometry), read in diagonal terms; every pair has some."""
    mask = mask.to(got.device)
    assert bool(mask.flatten(1).any(1).all()), "a pair has no cell"
    b, s, j = mask.nonzero().unbind(1)
    jw = j - K0_got + K0_want
    assert bool((jw >= 0).all()) and bool((jw < want.shape[2]).all())
    g, w = got[b, s, j], want.to(got.device)[b, s, jw]
    bad = (g != w).nonzero()
    assert bad.numel() == 0, (
        f"{bad.shape[0]} of {g.numel()} cells differ, first (pair, score, "
        f"diagonal index) {[int(b[bad[0, 0]]), int(s[bad[0, 0]]), int(j[bad[0, 0]])]}: "
        f"{int(g[bad[0, 0]])} against {int(w[bad[0, 0]])}")


# (name, pairs, penalties, reduction, first cap)
CASES = [
    ("x4o6e2", pairs_of(1, 6, 100, 0.10), (4, 6, 2), (0, 0), 64),
    ("x1o1e1", pairs_of(2, 6, 80, 0.10), (1, 1, 1), (0, 0), 64),
    ("x3o5e1", pairs_of(3, 6, 90, 0.15), (3, 5, 1), (0, 0), 64),
    ("e0", pairs_of(4, 5, 40, 0.10), (4, 6, 0), (0, 0), 64),
    ("x0", pairs_of(5, 5, 40, 0.10), (0, 6, 2), (0, 0), 64),
    ("o0", pairs_of(6, 5, 60, 0.10), (4, 0, 2), (0, 0), 64),
    ("reduce-10-25", pairs_of(7, 6, 120, 0.20), (4, 6, 2), (10, 25), 64),
    ("reduce-5-10", pairs_of(8, 6, 80, 0.05), (4, 6, 2), (5, 10), 64),
    ("empty-and-one-base",
     encoded([("", ""), ("A", ""), ("", "C"), ("A", "A"), ("A", "C"),
              ("AC", "G"), ("G", "TTA"), ("ACGT", "")]), (4, 6, 2), (0, 0),
     64),
    ("length-300", pairs_of(9, 3, 300, 0.05), (4, 6, 2), (0, 0), 64),
    ("mixed-lengths",
     pairs_of(10, 3, 20, 0.1) + pairs_of(11, 3, 150, 0.1), (4, 6, 2),
     (0, 0), 64),
    ("cap-overflow", pairs_of(12, 3, 120, 0.45), (4, 6, 2), (0, 0), 64),
    ("large-open", pairs_of(13, 4, 60, 0.10), (4, 40, 2), (0, 0), 64),
    ("small-cap", pairs_of(14, 4, 64, 0.10), (2, 4, 2), (0, 0), 16),
]


def case_ids():
    return [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=case_ids())
def test_model_equals_torch_loop(case):
    """The scalar model of the kernel's loop against the torch-op loop:
    final scores and offsets, the store at every written cell, and the
    CIGARs from the model's store with noise in every other cell."""
    _, pairs, (x, o, e), (rl, rd), scap = case
    pat, txt, plen, tlen = chunk_arrays(pairs)
    t = [torch.from_numpy(a) for a in (pat, txt, plen, tlen)]
    want = wfa._forward_chunk_torch(*t, scap, x, o, e, rl, rd)
    got, cells = model_chunk(pat, txt, plen, tlen, scap, x, o, e, rl, rd)
    assert got.fscore.tolist() == want.fscore.tolist()
    assert got.foff.tolist() == want.foff.tolist()
    assert got.max_score == want.max_score
    assert_store_equal(got.store, want.store,
                       cells_mask(cells, want.fscore.tolist(),
                                  got.store.shape), got.K0, want.K0)
    # the per-pair loop resumes no more than the lock-step one, each pair
    # stepping to its own score
    assert got.resumes <= want.resumes
    assert got.steps == got.max_score + 1
    if got.resumes == 0:
        assert got.lane_steps == int(want.fscore.sum()) + len(pairs)
    assert got.lane_steps <= want.lane_steps * (got.resumes + 1)
    assert cigars(got, t[2], t[3], x, o, e) == cigars(want, t[2], t[3],
                                                      x, o, e)


@pytest.mark.parametrize("name", ["x4o6e2", "x1o1e1", "e0", "x0"])
def test_plain_mask_is_the_models_cells(name):
    """Without reduction the bounds alone give the written cells (the
    mask the card's benchmark-batch test reads)."""
    _, pairs, (x, o, e), _, scap = CASES[case_ids().index(name)]
    pat, txt, plen, tlen = chunk_arrays(pairs)
    got, cells = model_chunk(pat, txt, plen, tlen, scap, x, o, e)
    fscore = got.fscore.tolist()
    assert torch.equal(
        plain_mask(fscore, got.K0, *got.store.shape[1:], x, o, e),
        cells_mask(cells, fscore, got.store.shape))


def test_cap_overflow_case_resumes():
    """The cap case overflows the first cap of both loops."""
    _, pairs, (x, o, e), _, scap = CASES[case_ids().index("cap-overflow")]
    pat, txt, plen, tlen = chunk_arrays(pairs)
    got, _ = model_chunk(pat, txt, plen, tlen, scap, x, o, e)
    assert got.resumes >= 1 and got.max_score >= scap


@pytest.mark.parametrize("pos", [0, 1, 5, 7, 8, 13, 30, 31])
def test_match_run_is_the_common_prefix(pos):
    """The 8-byte compare gives the plain common prefix, clamped, across
    word boundaries and at the row's end."""
    rng = np.random.default_rng(pos)
    a = rng.integers(0, 4, 32).astype(np.uint8)
    b = a.copy()
    if pos < 32:
        b[pos:] = (b[pos:] + 1) % 4
    for v in (0, 3, 8):
        for lim in (1, 7, 8, 9, 32 - v):
            plain = 0
            while plain < lim and a[v + plain] == b[v + plain]:
                plain += 1
            assert match_run(a.tobytes(), v, b.tobytes(), v, lim) == plain


def test_ring_slots_and_workspace():
    """The M ring has one slot more than the torch version's; I and D
    read back e, or share the M ring's size where e = 0."""
    assert wfa_cuda.ring_slots(4, 6, 2) == (10, 3)
    assert wfa_cuda.ring_slots(4, 6, 0) == (8, 8)
    assert wfa_cuda.ring_slots(0, 6, 2) == (10, 3)
    assert wfa_cuda.workspace_words(256, 4, 6, 2) == 16 * 259


@pytest.mark.parametrize("shape,shared", [
    ((96, 96, 256, 4, 6, 2), True),          # the benchmark's pairs
    ((1024, 1024, 2048, 4, 6, 2), False),    # long pairs at a grown cap
    ((96, 96, 256, 4, 200, 2), False),       # a large gap-open penalty
])
def test_ring_placement_follows_its_size(shape, shared):
    """Shared memory where two pairs' workspaces fit on an SM (H100: 227
    KB a block), else the device scratch."""
    assert wfa_cuda.in_shared(*shape, optin=232448) == shared


def test_cpu_tensors_run_the_torch_loop(monkeypatch):
    """CPU tensors never reach the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(wfa_cuda, "wfa_forward", refuse)
    got = wfa.wfa_batch(seqpairs(pairs_of(15, 4, 50, 0.1)), device="cpu")
    assert len(got) == 4 and all(got)


def test_wrapper_refuses_cpu_tensors():
    pat, txt, plen, tlen = (torch.from_numpy(a)
                            for a in chunk_arrays(pairs_of(16, 2, 30, 0.1)))
    with pytest.raises(ValueError, match="runs on cuda"):
        wfa_cuda.wfa_forward(pat, txt, plen, tlen, 98, 256, 64, 4, 6, 2)


@pytest.mark.parametrize("bad,match", [
    (lambda t: (t[0].int(), *t[1:]), "pat must be torch.uint8"),
    (lambda t: (t[0], t[1], t[2][:1], t[3]), "plen must be torch.int32"),
    (lambda t: (t[0][:, :30].contiguous(), *t[1:]),
     "pat's width must be a multiple of 8"),
    (lambda t: (t[0], t[1][:, ::2], *t[2:]), "txt must be contiguous"),
])
def test_wrapper_checks_its_inputs(bad, match):
    """Shapes, types, widths and layout are checked before any pointer
    reaches the kernel."""
    t = [torch.from_numpy(a) for a in chunk_arrays(pairs_of(19, 3, 40, 0.1))]
    with pytest.raises(ValueError, match=match):
        wfa_cuda._check(*bad(t))


@pytest.mark.parametrize("case", CASES, ids=case_ids())
def test_walk_model_equals_torch_walk(case):
    """The scalar model of the backtrace kernel against the lock-step
    torch walk, both over the torch-op loop's store."""
    _, pairs, (x, o, e), (rl, rd), scap = case
    pat, txt, plen, tlen = chunk_arrays(pairs)
    t = [torch.from_numpy(a) for a in (pat, txt, plen, tlen)]
    fw = wfa._forward_chunk_torch(*t, scap, x, o, e, rl, rd)
    T = wfa._backtrace_steps(fw, x, e)
    got = model_walk(fw.store.numpy(), fw.fscore, fw.foff, plen, tlen,
                     fw.K0, x, o, e, T)
    assert_walk_equal(got[:4], torch_walk(fw, t[2], t[3], x, o, e, T), T)


@pytest.mark.parametrize("case", CASES, ids=case_ids())
def test_walk_model_reads_only_written_cells(case):
    """Over the score-loop model's store, noise wherever the kernel
    writes nothing, the walk model reads only cells the score loop wrote
    (diagonals [lo, hi] of scores up to the pair's final score) and
    gives the torch walk's records over the torch-op loop's store."""
    _, pairs, (x, o, e), (rl, rd), scap = case
    pat, txt, plen, tlen = chunk_arrays(pairs)
    t = [torch.from_numpy(a) for a in (pat, txt, plen, tlen)]
    want = wfa._forward_chunk_torch(*t, scap, x, o, e, rl, rd)
    fw, cells = model_chunk(pat, txt, plen, tlen, scap, x, o, e, rl, rd,
                            seed=len(pairs))
    T = wfa._backtrace_steps(fw, x, e)
    got = model_walk(fw.store.numpy(), fw.fscore, fw.foff, plen, tlen,
                     fw.K0, x, o, e, T)
    fscore = fw.fscore.tolist()
    for b, read in enumerate(got[4]):
        assert all(cell in cells[b] and cell[0] <= fscore[b]
                   for cell in read), f"pair {b} read an unwritten cell"
    assert_walk_equal(got[:4], torch_walk(want, t[2], t[3], x, o, e, T), T)


def random_walk_inputs(seed, B=96, Scap=40, D=48, K0=20):
    """A store of random op codes and runs at every cell, with random
    lengths, final scores and offsets, some of them past the sequences'
    ends: walks that start outside the alignment, so that the op
    suppression and the one invalid -> valid gap (which exact stores
    never reach) run, and walks that leave the store's diagonals.
    Returns a `_Forward` and (plen, tlen)."""
    rng = np.random.default_rng(seed)
    shape = (B, Scap, D)
    word = (rng.integers(0, 5, shape) | rng.integers(0, 2, shape) << 3
            | rng.integers(0, 2, shape) << 4 | rng.integers(0, 4, shape) << 8)
    plen, tlen = (torch.from_numpy(rng.integers(0, 30, B).astype(np.int32))
                  for _ in range(2))
    fscore = torch.from_numpy(rng.integers(0, Scap, B).astype(np.int32))
    foff = torch.from_numpy(rng.integers(0, 40, B).astype(np.int32))
    fw = wfa._Forward(torch.from_numpy(word.astype(np.int32)), fscore, foff,
                      K0, Scap, int(fscore.max()), 0, 0, 0)
    return fw, plen, tlen


RANDOM_WALKS = [(31, (4, 6, 2)), (32, (1, 1, 1)), (33, (0, 6, 2)),
                (34, (4, 6, 0))]


@pytest.mark.parametrize("seed,pen", RANDOM_WALKS)
def test_walk_model_equals_torch_walk_on_random_stores(seed, pen):
    """The walk model against the torch walk where every branch of the
    walk runs, to the store's height."""
    fw, plen, tlen = random_walk_inputs(seed)
    x, o, e = pen
    want = torch_walk(fw, plen, tlen, x, o, e, fw.scap)
    assert (want[3][0] >= 0).any(), "no walk met the invalid -> valid gap"
    got = model_walk(fw.store.numpy(), fw.fscore, fw.foff, plen, tlen,
                     fw.K0, x, o, e, fw.scap)
    assert_walk_equal(got[:4], want, fw.scap)


def test_cpu_tensors_run_the_torch_walk(monkeypatch):
    """CPU tensors never reach the backtrace kernel's wrapper, and the
    run counts the lock-step walk's steps."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(wfa_cuda, "wfa_backtrace", refuse)
    stats = {}
    got = wfa.wfa_batch(seqpairs(pairs_of(20, 4, 50, 0.1)), device="cpu",
                        stats=stats)
    assert len(got) == 4 and all(got)
    assert stats["bt_steps"] % wfa.BT_UNROLL == 0 and stats["bt_steps"] > 0


def test_backtrace_wrapper_refuses_cpu_tensors():
    fw = wfa._forward_chunk_torch(
        *(torch.from_numpy(a) for a in chunk_arrays(
            pairs_of(21, 2, 30, 0.1))), 64, 4, 6, 2, 0, 0)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="runs on cuda"):
        wfa_cuda.wfa_backtrace(fw.store, fw.fscore, fw.foff, lens, lens,
                               fw.K0, 4, 6, 2, 8)


@pytest.mark.parametrize("bad,match", [
    (lambda a: dict(a, store=a["store"].long()),
     "store must be a contiguous"),
    (lambda a: dict(a, store=a["store"].transpose(1, 2)),
     "store must be a contiguous"),
    (lambda a: dict(a, foff=a["foff"][:1]), "foff must be a contiguous"),
    (lambda a: dict(a, tlen=a["tlen"].long()), "tlen must be a contiguous"),
    (lambda a: dict(a, K0=a["store"].shape[2]), "K0 .* must lie in"),
    (lambda a: dict(a, T=-1), "T -1 >= 0"),
])
def test_backtrace_wrapper_checks_its_inputs(bad, match):
    """Types, shapes, layout and the geometry are checked before any
    pointer reaches the backtrace kernel."""
    fw, plen, tlen = random_walk_inputs(35, B=4)
    args = dict(store=fw.store, fscore=fw.fscore, foff=fw.foff, plen=plen,
                tlen=tlen, K0=fw.K0, T=8)
    wfa_cuda._check_backtrace(**args)
    with pytest.raises(ValueError, match=match):
        wfa_cuda._check_backtrace(**bad(args))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.cuda.get_device_name(0)


def on_card(arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def kernel_vs_torch_loop(arrays, scap, x, o, e, rl, rd, mask, fscore_cpu):
    """The kernel and the torch-op loop on the card, on one chunk: equal
    final scores, offsets, stores at the cells of `mask` and CIGARs.
    Returns the kernel's `_Forward`."""
    t = on_card(arrays)
    launches = wfa_cuda.LAUNCHES
    got = wfa._forward_chunk(*t, scap, x, o, e, rl, rd)
    assert wfa_cuda.LAUNCHES == launches + got.resumes + 1
    want = wfa._forward_chunk_torch(*t, scap, x, o, e, rl, rd)
    torch.cuda.synchronize()
    assert got.fscore.tolist() == want.fscore.tolist() == fscore_cpu
    assert got.foff.tolist() == want.foff.tolist()
    assert got.max_score == want.max_score
    assert_store_equal(got.store, want.store, mask, got.K0, want.K0)
    assert cigars(got, t[2], t[3], x, o, e) == cigars(want, t[2], t[3],
                                                      x, o, e)
    return got


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=case_ids())
def test_kernel_equals_torch_loop_on_card(card, case):
    _, pairs, (x, o, e), (rl, rd), scap = case
    arrays = chunk_arrays(pairs)
    model, cells = model_chunk(*arrays, scap, x, o, e, rl, rd)
    fscore = model.fscore.tolist()
    got = kernel_vs_torch_loop(
        arrays, scap, x, o, e, rl, rd,
        cells_mask(cells, fscore, model.store.shape), fscore)
    assert (got.K0, got.scap, got.resumes, got.steps, got.lane_steps) == \
        (model.K0, model.scap, model.resumes, model.steps, model.lane_steps)


def plain_mask(fscore, K0, S, D, x, o, e):
    """Without reduction a wavefront's bounds do not depend on the bases:
    (B, S, D) bool, each pair's cells [lo, hi] of every score up to its
    final score, from the recurrence of the bounds alone."""
    RS = max(x, o + e) + 1
    m, i, d = {0: (1, 0, 0)}, {}, {}

    def get(w, s):
        return w.get(s, ABSENT) if s >= 0 else ABSENT

    rows = np.zeros((S, D), bool)
    rows[0, K0] = True
    for sn in range(1, S):
        def src(dd):
            return sn - RS if dd == 0 else sn - dd
        srcs = [get(m, src(x)), get(m, src(o + e)), get(i, src(e)),
                get(d, src(e))]
        c = any(w[0] for w in srcs)
        lo = min(w[1] for w in srcs) - 1
        hi = max(w[2] for w in srcs) + 1
        m[sn] = (1, lo, hi) if c else ABSENT
        i[sn] = (1, lo, hi) if c and (srcs[1][0] or srcs[2][0]) else ABSENT
        d[sn] = (1, lo, hi) if c and (srcs[1][0] or srcs[3][0]) else ABSENT
        if c:
            rows[sn, max(lo + K0, 0):min(hi + K0, D - 1) + 1] = True
    upto = torch.arange(S)[None, :] <= torch.tensor(fscore)[:, None]
    return upto[:, :, None] & torch.from_numpy(rows)[None]


@pytest.mark.card
def test_kernel_on_a_benchmark_batch_on_card(card):
    """A chunk of one batch of the benchmark's `pairs-96` traffic: the
    kernel with its rings in shared memory against the torch-op loop,
    and the entry's CIGARs on the card against the CPU run's."""
    import json
    from h100_bench.generators.pairs import batches
    root = pathlib.Path(__file__).resolve().parent.parent
    traffic = json.loads((root / "h100_bench" / "traffic" /
                          "pairs-96.json").read_text())
    batch = next(iter(batches(traffic, 2147483711, [0])))
    pairs = SeqPairs(batch.patterns()[:4096], batch.texts()[:4096])
    arrays = chunk_arrays(list(zip(pairs.patterns, pairs.texts)))
    x, o, e = 4, 6, 2
    Lp, Lt = arrays[0].shape[1], arrays[1].shape[1]
    K0, D = wfa._geometry(Lp, Lt, 128)
    assert wfa_cuda.in_shared(
        Lp, Lt, D, x, o, e,
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    t = on_card(arrays)
    got = wfa._forward_chunk(*t, 128, x, o, e, 0, 0)
    fscore = got.fscore.tolist()
    mask = plain_mask(fscore, got.K0, *got.store.shape[1:], x, o, e)
    kernel_vs_torch_loop(arrays, 128, x, o, e, 0, 0, mask, fscore)
    assert got.lane_steps == sum(fscore) + len(fscore)
    sub = SeqPairs(pairs.patterns[:512], pairs.texts[:512])
    assert wfa.wfa_batch(pairs, device="cuda")[:512] == \
        wfa.wfa_batch(sub, device="cpu")


@pytest.mark.card
def test_kernel_with_its_rings_in_device_memory_on_card(card):
    """A gap-open penalty whose rings do not fit two to an SM: the same
    kernel keeps them in the device scratch."""
    pairs = pairs_of(17, 16, 96, 0.10)
    x, o, e = 4, 200, 2
    arrays = chunk_arrays(pairs)
    K0, D = wfa._geometry(arrays[0].shape[1], arrays[1].shape[1], 64)
    assert not wfa_cuda.in_shared(
        arrays[0].shape[1], arrays[1].shape[1], D, x, o, e,
        torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    model, cells = model_chunk(*arrays, 64, x, o, e)
    fscore = model.fscore.tolist()
    kernel_vs_torch_loop(arrays, 64, x, o, e, 0, 0,
                         cells_mask(cells, fscore, model.store.shape), fscore)


@pytest.mark.card
def test_two_shards_of_one_card(card):
    """`wfa_batch(mesh=)` with two shards on the one card: one score-loop
    kernel a shard's chunk (and its resumes) and one backtrace kernel,
    the CIGARs those of the CPU run."""
    from genarchbench_tpu_torch.sharding.mesh import Mesh
    sp = seqpairs(pairs_of(18, 200, 100, 0.08))
    dev = torch.device("cuda", 0)
    launches, bt_launches = wfa_cuda.LAUNCHES, wfa_cuda.BT_LAUNCHES
    got = wfa.wfa_batch(sp, mesh=Mesh((dev, dev)))
    assert wfa_cuda.LAUNCHES >= launches + 2
    assert wfa_cuda.BT_LAUNCHES == bt_launches + 2
    assert got == wfa.wfa_batch(sp, device="cpu")


def backtrace_kernel_vs_torch_walk(fw, plen, tlen, x, o, e, mask=None):
    """The backtrace kernel and the lock-step torch walk on the card over
    the store of the kernel's score loop `fw`: equal records up to each
    pair's last step, zeros after, and equal CIGARs, in one launch.  With
    a mask, every other cell of the store is overwritten with noise
    before the kernel's launch (the torch walk reads the store as the
    score loop left it)."""
    T = wfa._backtrace_steps(fw, x, e)
    want = torch_walk(fw, plen, tlen, x, o, e, T)
    store = fw.store
    if mask is not None:
        gen = torch.Generator(device=store.device).manual_seed(T)
        noise = torch.randint(-(1 << 31), 1 << 31, store.shape,
                              dtype=torch.int64, device=store.device,
                              generator=gen).to(torch.int32)
        store = torch.where(mask.to(store.device), store, noise)
        del noise
    launches = wfa_cuda.BT_LAUNCHES
    nmats, ops, lanes, steps = wfa_cuda.wfa_backtrace(
        store, fw.fscore, fw.foff, plen, tlen, fw.K0, x, o, e, T)
    assert wfa_cuda.BT_LAUNCHES == launches + 1
    torch.cuda.synchronize()
    assert_walk_equal((int(steps), nmats.cpu().numpy(), ops.cpu().numpy(),
                       lanes.cpu().numpy()), want, T)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=case_ids())
def test_backtrace_kernel_equals_torch_walk_on_card(card, case):
    """Every case: the backtrace kernel over the score-loop kernel's
    store, as written and with its unwritten cells noise."""
    _, pairs, (x, o, e), (rl, rd), scap = case
    arrays = chunk_arrays(pairs)
    model, cells = model_chunk(*arrays, scap, x, o, e, rl, rd)
    t = on_card(arrays)
    fw = wfa._forward_chunk(*t, scap, x, o, e, rl, rd)
    assert fw.store.shape == model.store.shape
    mask = cells_mask(cells, model.fscore.tolist(), model.store.shape)
    for noise in (None, mask):
        backtrace_kernel_vs_torch_walk(fw, t[2], t[3], x, o, e, noise)


@pytest.mark.card
@pytest.mark.parametrize("seed,pen", RANDOM_WALKS)
def test_backtrace_kernel_on_random_stores_on_card(card, seed, pen):
    """The backtrace kernel against the torch walk where every branch of
    the walk runs."""
    fw, plen, tlen = random_walk_inputs(seed)
    fw = fw._replace(store=fw.store.cuda(), fscore=fw.fscore.cuda(),
                     foff=fw.foff.cuda(), max_score=fw.scap)
    backtrace_kernel_vs_torch_walk(fw, plen.cuda(), tlen.cuda(), *pen)


@pytest.mark.card
def test_backtrace_kernel_on_a_benchmark_batch_on_card(card):
    """A 4,096-pair chunk of one batch of the benchmark's `pairs-96`
    traffic: the backtrace kernel against the torch walk, as written and
    over noise; then the entry launches it once a chunk and gives the
    CPU run's CIGARs."""
    import json
    from h100_bench.generators.pairs import batches
    root = pathlib.Path(__file__).resolve().parent.parent
    traffic = json.loads((root / "h100_bench" / "traffic" /
                          "pairs-96.json").read_text())
    batch = next(iter(batches(traffic, 2147483713, [0])))
    pairs = SeqPairs(batch.patterns()[:4096], batch.texts()[:4096])
    arrays = chunk_arrays(list(zip(pairs.patterns, pairs.texts)))
    x, o, e = 4, 6, 2
    t = on_card(arrays)
    fw = wfa._forward_chunk(*t, 128, x, o, e, 0, 0)
    mask = plain_mask(fw.fscore.tolist(), fw.K0, *fw.store.shape[1:], x, o,
                      e)
    for noise in (None, mask):
        backtrace_kernel_vs_torch_walk(fw, t[2], t[3], x, o, e, noise)
    del mask
    stats = {}
    launches = wfa_cuda.BT_LAUNCHES
    got = wfa.wfa_batch(pairs, device="cuda", stats=stats, max_batch=1024)
    assert stats["chunks"] == 4
    assert wfa_cuda.BT_LAUNCHES == launches + stats["chunks"]
    assert 0 < stats["bt_steps"] <= 4 * wfa._backtrace_steps(fw, x, e)
    sub = SeqPairs(pairs.patterns[:512], pairs.texts[:512])
    assert got[:512] == wfa.wfa_batch(sub, device="cpu")
