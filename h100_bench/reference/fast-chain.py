"""mm2-fast's 32-bit chaining as GenArchBench's fast-chain benchmark runs
it (`benchmarks/fast-chain/src/host_kernel.cpp:803-866`, the scalar loop
that its AVX512, AVX2 and SVE loops reproduce), in plain NumPy.

For each anchor i the reference scans j = i-1 down to st(i):

    skip j if dr == 0 or dq <= 0 or dq > max_dist_x or dq > max_dist_y
           or dd > bw
    sc = min(dq, dr, q_span) - ((int)(dd * 0.01f * avg_qspan)
                                + (log2 dd >> 1)) + f[j]
    if sc > max_f: max_f, max_j = sc, j

with max_f = q_span and max_j = -1 at the start, dr = (int32)(x_lo[i] -
x_lo[j]), dq = qi[i] - qi[j], dd = |dr - dq|, the gap cost in float32,
and no segment ids, skip heuristic or peaks.  The winner is the largest
j that reaches the window's maximum.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from h100_bench.reference._anchors import (  # noqa: F401 (work)
    I32_MIN, Planes, ilog2, linear_gap, work)

PRECISION = "f32"


def solve(batch, config: dict, precision: str = PRECISION,
          counts: Optional[dict] = None
          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(scores, parents) of every record of `batch`, int32, with parents
    as indices within the record (-1 for none), with the configuration's
    max_chain_iter and the gap cost in `precision`.  `counts`, when a
    dict, gets `anchors` (mm2-fast has no skip rule)."""
    if counts is not None:
        counts["anchors"] = counts.get("anchors", 0) + len(batch.x)
    P = Planes(batch, config["max_chain_iter"])
    f, par = P.plane(), P.plane() - 1
    avg = P.rows(batch.avg_qspan.astype(np.float32))
    mdxy = P.rows(np.minimum(batch.max_dist_x, batch.max_dist_y)
                  .astype(np.int32))
    bw = P.rows(batch.bw.astype(np.int32))
    slot = np.arange(P.L)
    for i, a, d in P.steps():
        c = P.L + i
        span = P.span[:a, c]
        if d == 0:
            f[:a, c] = span
            continue
        valid = slot[:d] < P.wlen[:a, c, None]
        dr = (P.xl[:a, c, None] - P.window(P.xl, i, a, d)).view(np.int32)
        dq = P.qi[:a, c, None] - P.window(P.qi, i, a, d)
        dd = np.abs(dr - dq)
        skip = (dr == 0) | (dq <= 0) | (dq > mdxy[:a]) | (dd > bw[:a])
        gap = linear_gap(dd, avg[:a], precision) + (ilog2(dd) >> 1)
        sc = (np.minimum(np.minimum(dq, dr), span[:, None]) - gap
              + P.window(f, i, a, d))
        sc = np.where(valid & ~skip, sc, I32_MIN).astype(np.int32)
        best = sc.max(1)
        first = np.argmax(sc == best[:, None], axis=1)
        won = best > span
        f[:a, c] = np.where(won, best, span)
        par[:a, c] = np.where(won, i - 1 - first, -1)
    return list(zip(P.split(f), P.split(par)))
