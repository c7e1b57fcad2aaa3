"""minimap2's `chain_dp` as GenArchBench's chain benchmark runs it
(`benchmarks/chain/src/host_kernel.cpp:30-94`), in plain NumPy.

For each anchor i the reference scans j = i-1 down to st(i):

    skip j if (same sid and dr == 0) or dq <= 0
           or (same sid and dq > max_dist_y) or dq > max_dist_x
           or (same sid and dd > bw)
           or (n_segs > 1 and same sid and dr > max_dist_y)
    sc = min(dq, dr, q_span) - gap + f[j]    (+1 when sids differ, dr == 0)
    gap = (int)(dd * .01 * avg_qspan) + (log2 dd >> 1)          same sid
          0 if dr == 0, else min((int)(dd * .01 * avg), log2 dd)  otherwise
    if sc > max_f: max_f, max_j = sc, j; n_skip -= (n_skip > 0)
    elif t[j] == i: n_skip += 1; break when n_skip > max_chain_skip
    if p[j] >= 0: t[p[j]] = i

with max_f = q_span and max_j = -1 at the start, dr = (int32)(x_lo[i] -
x_lo[j]), dq = qi[i] - qi[j] and dd = |dr - dq| in int32, and the peak
v[i] = v[max_j] if max_j >= 0 and v[max_j] > max_f, else max_f.

Vectorised over records and over the window: anchor i of every record
is one step.  Within a step, the whole window is scored at once; the
scan's running maximum is a prefix maximum over the slots in scan order;
t[j] == i holds when some scored j' > j has parent j, which is one
scatter of the window's parents; and n_skip, a counter with a floor at
0, is followed slot by slot only in the rows where more than
max_chain_skip skip hits could make it break.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from h100_bench.reference._anchors import (  # noqa: F401 (work)
    I32_MIN, Planes, ilog2, linear_gap, work)

PRECISION = "f64"


def solve(batch, config: dict, precision: str = PRECISION,
          counts: Optional[dict] = None
          ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(scores, parents, peaks) of every record of `batch`, int32, with
    parents as indices within the record (-1 for none), with the
    configuration's max_chain_iter and max_chain_skip and the gap cost in
    `precision`.  `counts`, when a dict, gets `anchors` and
    `skip_breaks`, the anchors whose scan the skip rule ended early."""
    max_skip = config["max_chain_skip"]
    P = Planes(batch, config["max_chain_iter"])
    f, par, peak = P.plane(), P.plane() - 1, P.plane()
    avg = P.rows(batch.avg_qspan.astype(np.float32))
    mdx, mdy, bw = (P.rows(v.astype(np.int32)) for v in (
        batch.max_dist_x, batch.max_dist_y, batch.bw))
    multi = P.rows(batch.n_segs > 1)
    slot = np.arange(P.L)
    breaks = 0
    for i, a, d in P.steps():
        c = P.L + i
        span = P.span[:a, c]
        if d == 0:
            f[:a, c] = peak[:a, c] = span
            continue

        def win(p):
            return P.window(p, i, a, d)

        k = slot[:d]
        valid = k < P.wlen[:a, c, None]
        dr = (P.xl[:a, c, None] - win(P.xl)).view(np.int32)
        dq = P.qi[:a, c, None] - win(P.qi)
        seq = P.sid[:a, c, None] == win(P.sid)
        dd = np.abs(dr - dq)
        skip = (dq <= 0) | (dq > mdx[:a]) | (seq & (
            (dr == 0) | (dq > mdy[:a]) | (dd > bw[:a])
            | (multi[:a] & (dr > mdy[:a]))))
        eff = valid & ~skip
        lin = linear_gap(dd, avg[:a], precision)
        log_dd = ilog2(dd)
        gap = np.where(seq, lin + (log_dd >> 1),
                       np.where(dr == 0, 0, np.minimum(lin, log_dd)))
        sc = (np.minimum(np.minimum(dq, dr), span[:, None])
              + (~seq & (dr == 0)) - gap + win(f))
        sc = np.where(eff, sc, I32_MIN).astype(np.int32)

        # max_f as the scan reaches each slot, and the slots that beat it
        before = np.full_like(sc, I32_MIN)
        np.maximum.accumulate(sc[:, :-1], axis=1, out=before[:, 1:])
        better = eff & (sc > np.maximum(before, span[:, None]))
        # a break needs more than max_skip skip hits
        cand = np.flatnonzero((eff & ~better).sum(1) > max_skip)
        if len(cand):
            e, b = eff[cand], better[cand]
            # t[j] == i at slot k: a scored slot before k has parent j
            pj = win(par)[cand]
            tgt = np.where(e & (pj >= 0) & (i - 1 - pj < d), i - 1 - pj, d)
            hit = np.zeros((len(cand), d + 1), bool)
            hit[np.arange(len(cand))[:, None], tgt] = True
            skip_hit = e & ~b & hit[:, :d]
            # n_skip, +1 at a skip hit and -1 (not below 0) at a better
            # slot, is the walk's sum less its lowest point so far
            walk = np.cumsum(skip_hit.astype(np.int32) - b, axis=1)
            n_skip = walk - np.minimum(np.minimum.accumulate(walk, axis=1), 0)
            brk = skip_hit & (n_skip > max_skip)
            stop = np.where(brk.any(1), brk.argmax(1), d)
            breaks += int(brk.any(1).sum())
            sc[cand] = np.where(k < stop[:, None], sc[cand], I32_MIN)
        best = sc.max(1)
        first = np.argmax(sc == best[:, None], axis=1)
        won = best > span
        max_f = np.where(won, best, span)
        parent = np.where(won, i - 1 - first, -1)
        pk = peak[np.arange(a), P.L + np.maximum(parent, 0)]
        f[:a, c], par[:a, c] = max_f, parent
        peak[:a, c] = np.where(won & (pk > max_f), pk, max_f)
    if counts is not None:
        counts["anchors"] = counts.get("anchors", 0) + len(batch.x)
        counts["skip_breaks"] = counts.get("skip_breaks", 0) + breaks
    return list(zip(P.split(f), P.split(par), P.split(peak)))
