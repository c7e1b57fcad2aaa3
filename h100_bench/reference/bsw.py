"""BWA-MEM2's banded Smith-Waterman seed extension, as GenArchBench's bsw
benchmark runs it (`bandedSWA.cpp`: getScores16 :3478, the batch wrapper
smithWatermanBatchWrapper16 :3510-3760, the kernel smithWaterman128_16
:3766-4150, ZSCORE16 :3380-3394), in plain NumPy.

The benchmark's output is one score a pair, diffed exactly, and a pair's
score depends on the other pairs of its group, so the reference keeps
the vector path's grouping and everything the group shares:

* SORT_PAIRS: each slice of `batch_size` consecutive pairs, padded to a
  multiple of `lanes` with empty pairs, is sorted stably by target
  length (a counting sort; the padding sorts first) and cut into groups
  of `lanes` pairs (SIMD_WIDTH16, 8), run together;
* each pair's band limit from its query length (the wrapper's double
  arithmetic on int16 temporaries):
  min(w, (qlen * a + end_bonus - o) / e + 1) for the insertion and the
  deletion costs, each at least 1;
* row i of a group runs over the columns [beg, end) the group shares,
  beg = max(nbeg, i - w) and end = min(nend, i + w + 1, the longest
  query), each pair holding its own head and tail within them, which
  move in by its band limit and are zeroed where they do (when any pair
  of the group moved);
* the cell: M = 0 where the stored H is 0, else H + the substitution
  score (a, -b, or `ambig` for an N on either side); the insertion chain
  E(beg) = 0, E(j + 1) = max(max(M(j) - o_ins - e_ins, 0), E(j) - e_ins);
  H = max(M, E, F); the next row's F = max(max(M - o_del - e_del, 0),
  F - e_del); the row's H is stored one column on (column beg takes the
  deletion boundary of column 0, or 0), and H and F are zeroed outside
  [head, tail];
* a pair stops raising its best score once its row passes its band, its
  head meets its tail, its row's best is 0, or the vector z-drop (with no
  gap-extension scaling, unlike the scalar code) exceeds `zdrop`; a group
  stops at a row whose every pair's best is 0;
* after a row the group's band narrows to its nonzero columns of F or H
  over all pairs, and each pair's head and tail to its own, among the
  pairs still running.

Scores stay far below 2^15 on these inputs, so int16 never wraps and the
DP runs in int32 (`exact`).  The control (`int8`) is the same DP with
its scores held in 8 bits, saturating at 127, as getScores8 would hold
them: the start score and every cell's M.

`band_cells` counts the cells the rows evaluate, (end - beg) x lanes a
row of every group until it stops, the work of the vector kernel;
`cells` is the benchmark's own counter, numCellsComputed, min(2w + 1,
qlen) x tlen a pair, the north star's unit.  `bound` gives the least
time the card could take for the band cells and the bytes, with the
peaks of `harness/roofline.py`; `work` reads it only when asked.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from h100_bench.harness.roofline import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S

PRECISION = "exact"
SATURATE = {"exact": None, "int8": 127}
N = 4                       # the input's code of an ambiguous base
T_PAD, Q_PAD = 5, 6         # past a target's and a query's end: never equal
NEG = -(1 << 28)
BUNCH = 256                 # groups a bunch, run side by side


def _lengths(offs: np.ndarray) -> np.ndarray:
    return (offs[1:] - offs[:-1]).astype(np.int64)


def band_limits(qlen: np.ndarray, c: dict) -> np.ndarray:
    """Each pair's band limit from its query length (the wrapper's
    :3696-3718): (qlen * a + end_bonus - o) as an unsigned 16-bit value,
    over e, plus 1, truncated, at least 1, for the insertion and the
    deletion costs; at most w."""
    q = np.asarray(qlen, np.int64) * c["match"]

    def limit(o, e):
        t = (q + c["end_bonus"] - o).astype(np.uint16).astype(np.float64)
        return np.maximum((t / e + 1.0).astype(np.int64), 1)

    return np.minimum(np.minimum(c["w"], limit(c["o_ins"], c["e_ins"])),
                      limit(c["o_del"], c["e_del"]))


def groups(batch, c: dict) -> np.ndarray:
    """(G, lanes) pair indices of each group, -1 for padding: each record
    (a slice of at most `batch_size` pairs, every one but the last
    exactly that many) padded with empty pairs and sorted stably by
    target length."""
    bs, lanes = int(c["batch_size"]), int(c["lanes"])
    n = np.asarray(batch.n, np.int64)
    if len(n) and ((n[:-1] != bs).any() or n[-1] > bs or n[-1] < 1):
        raise ValueError(f"records of {n.tolist()} pairs are not slices of "
                         f"batch_size {bs}")
    tlen = _lengths(batch.r_offs)
    out, at = [], 0
    for size in n.tolist():
        ids = np.arange(at, at + size)
        pad = -size % lanes
        key = np.concatenate([tlen[ids], np.zeros(pad, np.int64)])
        ids = np.concatenate([ids, np.full(pad, -1)])
        out.append(ids[np.argsort(key, kind="stable")].reshape(-1, lanes))
        at += size
    return (np.concatenate(out) if out
            else np.zeros((0, lanes), np.int64))


def _planes(flat, offs, ids, width, pad):
    """(G, lanes, width) bases of pairs `ids`, `pad` past each end."""
    lens = np.where(ids >= 0, _lengths(offs)[np.maximum(ids, 0)], 0)
    col = np.arange(width)
    at = offs[np.maximum(ids, 0)][..., None] + col
    inside = col < lens[..., None]
    vals = np.concatenate([flat, np.zeros(1, flat.dtype)])[
        np.where(inside, at, len(flat))]
    return np.where(inside, vals, pad).astype(np.int8), lens


def extend(batch, c: dict, precision: str = PRECISION
           ) -> Tuple[np.ndarray, int]:
    """(each pair's score, the band cells the rows evaluated).  The
    groups run in bunches of about the same longest query, each bunch
    only as wide as its own (groups never meet, so the bunches change
    nothing but the work)."""
    top = SATURATE[precision]
    ids = groups(batch, c)
    scores = np.zeros(batch.pairs, np.int64)
    qlen_all = _lengths(batch.q_offs)
    width = np.where(ids >= 0, qlen_all[np.maximum(ids, 0)], 0).max(
        axis=1, initial=0)
    order = np.argsort(width, kind="stable")
    has_n = bool((batch.ref == N).any() or (batch.qry == N).any())
    cells = 0
    for part in np.array_split(order, max(1, len(order) // BUNCH)):
        g = ids[part]
        tgt, tlen = _planes(batch.ref, batch.r_offs, g,
                            max(int(_lengths(batch.r_offs)[
                                np.maximum(g, 0)].max(initial=0)), 1),
                            T_PAD)
        qry, qlen = _planes(batch.qry, batch.q_offs, g,
                            int(width[part].max(initial=0)) + 1, Q_PAD)
        h0 = np.where(g >= 0, batch.h0[np.maximum(g, 0)], 0).astype(np.int32)
        if top is not None:
            h0 = np.minimum(h0, top)
        out, n = _run(tgt, qry, tlen.astype(np.int32), qlen.astype(np.int32),
                      h0, band_limits(qlen, c).astype(np.int32), c, top,
                      has_n)
        real = g >= 0
        scores[g[real]] = out[real]
        cells += n
    return scores, cells


def _run(tgt, qry, tlen, qlen, h0, band, c, top, has_n):
    """The row loop over a bunch of groups at once, in int32; a group
    leaves the working set after its last row or a row whose every
    pair's best is 0.  Returns (each lane's best score, the band
    cells)."""
    G, L, W = qry.shape
    i32 = np.int32
    match, mis, amb = i32(c["match"]), i32(-c["mismatch"]), i32(c["ambig"])
    o_del, e_del, o_ins, e_ins = c["o_del"], c["e_del"], c["o_ins"], c["e_ins"]
    oe_ins, oe_del, w, zdrop = o_ins + e_ins, o_del + e_del, c["w"], c["zdrop"]
    cols = np.arange(W, dtype=i32)
    nrow = tlen.max(axis=1)
    ncol = qlen.max(axis=1)
    mlen = np.minimum(qlen + band, tlen)
    # row 0: the start score, and the insertions from it along the query
    H = np.where(cols == 0, h0[..., None],
                 np.maximum(h0[..., None] - oe_ins - (cols - 1) * e_ins, 0))
    H = np.where(cols < ncol[:, None, None], H, 0).astype(i32)
    F = np.zeros_like(H)
    head = np.zeros((G, L), i32)
    tail = qlen.copy()
    live = np.ones((G, L), bool)
    best, x, y = h0.copy(), np.zeros((G, L), i32), np.zeros((G, L), i32)
    nbeg, nend = np.zeros(G, i32), ncol.copy()
    out = h0.copy()
    cells = 0
    g = np.flatnonzero(nrow > 0)       # the working set
    state = [a[g] for a in (tgt, qry, H, F, head, tail, live, best, x, y,
                            nbeg, nend, ncol, nrow, qlen, band, mlen, h0)]
    i = 0
    while len(g):
        (tgt, qry, H, F, head, tail, live, best, x, y, nbeg, nend, ncol,
         nrow, qlen, band, mlen, h0) = state
        beg = np.maximum(nbeg, i - w)
        end = np.minimum(np.minimum(nend, i + w + 1), ncol)
        cells += int(np.maximum(end - beg, 0).sum()) * L
        b3, e3 = beg[:, None, None], end[:, None, None]
        # each pair's band moves in; where any pair's did, the cells it
        # left are zeroed
        old = head, tail
        head = np.maximum(head, i - band)
        tail = np.minimum(np.minimum(tail, i + 1 + band), qlen)
        moved = ((head != old[0]) | (tail != old[1])).any(axis=1)
        if moved.any():
            cut = (moved[:, None, None] & (cols >= b3)
                   & (cols < np.minimum(end, head.max(axis=1))[:, None, None])
                   & ((head[..., None] > cols) | (cols + 1 > tail[..., None])))
            H[cut] = 0
            F[cut] = 0
        live &= ~((i + 1 > mlen) | (tail <= head))
        # the row's cells
        t = tgt[:, :, i, None]
        s = np.where(t == qry, match, mis)
        if has_n:
            s = np.where((t == N) | (qry == N), amb, s)
        M = np.where(H == 0, 0, H + s)
        if top is not None:
            np.minimum(M, top, out=M)
        band_in = (cols >= b3) & (cols < e3)
        run = np.where(band_in, np.maximum(M - oe_ins, 0) + cols * e_ins,
                       NEG)
        np.maximum.accumulate(run, axis=2, out=run)
        rows = np.arange(len(g))
        at = np.minimum(beg, W - 1)    # past the last column: no band
        E = np.empty_like(M)
        E[:, :, 0] = 0
        E[:, :, 1:] = run[:, :, :-1] - cols[:-1] * e_ins
        E[rows, :, at] = 0
        Hn = np.maximum(np.maximum(M, E), F)
        Fn = np.maximum(np.maximum(M - oe_del, 0), F - e_del)
        # stored one column on; column beg takes the deletion boundary
        h10 = np.where(beg[:, None] == 0,
                       np.maximum(h0 - o_del - (i + 1) * e_del, 0), 0)
        on = np.empty_like(Hn)
        on[:, :, 0] = 0
        on[:, :, 1:] = Hn[:, :, :-1]
        on[rows, :, at] = h10
        keep = band_in & (head[..., None] <= cols) & (cols <= tail[..., None])
        H = np.where(band_in, np.where(keep, on, 0), H)
        F = np.where(band_in, np.where(keep, Fn, 0), F)
        H[rows, :, end] = np.where((end > beg)[:, None],
                                   Hn[rows, :, np.maximum(end - 1, 0)], h10)
        F[rows, :, end] = 0
        # the row's best of each pair and its last column
        mine = band_in & (cols < tail[..., None])
        row_best = np.maximum(np.where(mine, Hn, NEG).max(axis=2), 0)
        y1 = np.where(mine & (Hn == row_best[..., None]), cols + 1,
                      0).max(axis=2)
        stop = (row_best == 0).all(axis=1)
        live &= row_best != 0
        prev = best
        best = np.where(live, np.maximum(prev, row_best), prev)
        up = best > prev
        x = np.where(up, i + 1, x)
        y = np.where(up, y1, y)
        drop = (best - row_best) - np.abs((i + 1 - x) - (y1 - y))
        live &= ~(drop > zdrop)
        # the band narrows to the nonzero columns
        nonzero = (F != 0) | (H != 0)
        nz = nonzero.any(axis=1)                                 # (g, W)
        inside = (cols >= beg[:, None]) & (cols < end[:, None])
        upto = (cols >= beg[:, None]) & (cols <= end[:, None])
        first = np.where(inside & nz, cols, end[:, None]).min(axis=1)
        nbeg = np.where(first > beg, first - 1, nbeg)
        nend = np.minimum(np.where(upto & nz, cols, beg[:, None] - 1)
                          .max(axis=1) + 2, ncol)
        nzp = nonzero | ~live[..., None]
        first = np.where(inside[:, None] & nzp, cols,
                         end[:, None, None]).min(axis=2)
        head = np.where(first > beg[:, None], first, head)
        last = np.where(upto[:, None] & nzp, cols, b3 - 1).max(axis=2)
        tail = np.minimum(np.where(end[:, None] - last >= 1, last, tail) + 2,
                          qlen)
        i += 1
        state = [tgt, qry, H, F, head, tail, live, best, x, y, nbeg, nend,
                 ncol, nrow, qlen, band, mlen, h0]
        leaving = stop | (i >= nrow)
        if leaving.any():
            # a group that stopped keeps the best it had before this row
            out[g[leaving]] = np.where(stop[:, None], prev, best)[leaving]
            g = g[~leaving]
            state = [a[~leaving] for a in state]
    return out, cells


def solve(batch, config: dict, precision: str = PRECISION,
          counts: Optional[dict] = None) -> List[Tuple[np.ndarray]]:
    """(the scores of its pairs,) of every slice of `batch`, under the
    configuration's scoring, at `exact` or the control's `int8`.
    `counts`, when a dict, gets `anchors`, the pairs' bases."""
    s, _ = extend(batch, config, precision)
    if counts is not None:
        counts["anchors"] = counts.get("anchors", 0) + len(batch.ref) \
            + len(batch.qry)
    offs = batch.slice_offsets()
    return [(s[a:b],) for a, b in zip(offs[:-1].tolist(), offs[1:].tolist())]


def num_cells(batch, w: int) -> int:
    """numCellsComputed: min(2w + 1, qlen) x tlen summed over the pairs."""
    return int((np.minimum(2 * w + 1, _lengths(batch.q_offs))
                * _lengths(batch.r_offs)).sum())


class Work(dict):
    """A batch's work as `work` counts it.  `band_cells` and
    `bsw_bound_s` need the whole DP of every pair, which no answer of the
    run needs: they are computed at their first read (the traced run's
    `bsw_roofline`, after the window), not in the set-up."""

    LAZY = ("band_cells", "bsw_bound_s")

    def __init__(self, batch, config: dict, **counts):
        super().__init__(counts)
        self._batch, self._config = batch, config

    def __missing__(self, key: str):
        if key not in self.LAZY:
            raise KeyError(key)
        self.update(bound(self._batch, self._config))
        return self[key]


def bound(batch, config: dict) -> dict:
    """The band cells the rows evaluate (`band_cells`) and the least time
    the card could take for the batch (`bsw_bound_s`): the larger of the
    band cells' operations and of each base read once, a pair's four
    int32 inputs read once and its six int32 outputs written once."""
    _, band = extend(batch, config)
    bases = len(batch.ref) + len(batch.qry)
    return {"band_cells": band, "bsw_bound_s": max(
        band * config["ops_per_band_cell"] / PEAK_INT32_OPS_PER_S,
        (bases * config["bytes_per_base"]
         + batch.pairs * config["bytes_per_pair"]) / PEAK_BYTES_PER_S)}


def work(batch, config: dict) -> Work:
    """A batch's work as the reference counts it: its slices (`records`),
    its pairs, its bases (`anchors`), numCellsComputed (`cells`), and,
    read when asked for, `bound`'s `band_cells` and `bsw_bound_s`."""
    return Work(batch, config, records=len(batch), pairs=batch.pairs,
                anchors=len(batch.ref) + len(batch.qry),
                cells=num_cells(batch, config["w"]))
