"""Gap-affine global alignment scores, as GenArchBench's wfa benchmark
computes them with the WFA library in complete-wavefront mode
(`gap_affine/affine_wavefront_align.c:325-361`), by Gotoh's dynamic
programme in plain NumPy.

Under WFA's penalties a match costs 0, a mismatch x, and a gap of length
l o + l * e; the score of a pair is the least cost of a global alignment
of its pattern p and text t.  With H the best cost of p[:i] against
t[:j], E its best ending in a gap of the text (pattern bases left over,
WFA's D) and F its best ending in a gap of the pattern (WFA's I):

    E[i][j] = min(H[i-1][j] + o + e, E[i-1][j] + e)
    F[i][j] = min(H[i][j-1] + o + e, F[i][j-1] + e)
    H[i][j] = min(H[i-1][j-1] + (x if p[i-1] != t[j-1] else 0),
                  E[i][j], F[i][j])

with H[0][0] = 0 and a leading gap of length l costing o + l * e.
Vectorised over the pairs of a batch, a row at a time: with o >= 0 a gap
never opens better from a cell that a gap of the same row reached, so
the row's F is a prefix minimum over G = min(diagonal, E):

    F[i][j] = j * e + o + min over k < j of (G[k] - k * e)

The control (`control_precision` "band-B") runs the same DP confined to
the diagonals |i - j| <= B, a search that leaves part of the DP out;
where a pair's end lies outside the band its score is INF.

`bound` gives the offsets complete-wavefront WFA computes for each
pair (`wavefront_offsets`) and the least time the card could take for
them, with the peaks of `harness/roofline.py`; `work` reads it only
when asked.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from h100_bench.harness.roofline import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S

PRECISION = "exact"
INF = 1 << 28


def _band(precision: str) -> Optional[int]:
    if precision == PRECISION:
        return None
    if precision.startswith("band-"):
        return int(precision[len("band-"):])
    raise ValueError(f"unknown precision {precision!r}")


def _padded(offs: np.ndarray, flat: np.ndarray, fill: int) -> np.ndarray:
    lens = offs[1:] - offs[:-1]
    width = int(lens.max()) if len(lens) else 0
    out = np.full((len(lens), width), fill, np.uint8)
    out[np.arange(width) < lens[:, None]] = flat
    return out


def scores(batch, x: int, o: int, e: int,
           band: Optional[int] = None) -> np.ndarray:
    """(B,) int64: each pair's least gap-affine cost, or INF where the
    band leaves its end out."""
    plen = batch.p_offs[1:] - batch.p_offs[:-1]
    tlen = batch.t_offs[1:] - batch.t_offs[:-1]
    P = _padded(batch.p_offs, batch.pat, 255)
    T = _padded(batch.t_offs, batch.txt, 254)   # padding never matches
    B, Lt = T.shape
    rows = np.arange(B)
    j = np.arange(Lt + 1, dtype=np.int64)
    H = np.where(j == 0, 0, o + j * e)[None, :].repeat(B, 0)
    E = np.full((B, Lt + 1), INF, np.int64)
    out = np.full(B, INF, np.int64)

    def clip(i, *planes):
        if band is not None:
            for a in planes:
                a[:, np.abs(i - j) > band] = INF

    clip(0, H)
    out[plen == 0] = H[rows, tlen][plen == 0]
    for i in range(1, P.shape[1] + 1):
        E = np.minimum(H + o + e, E + e)
        G = E.copy()
        G[:, 1:] = np.minimum(G[:, 1:], H[:, :-1] + np.where(
            P[:, i - 1, None] == T, 0, x))
        clip(i, G, E)
        F = np.full_like(G, INF)
        F[:, 1:] = np.minimum.accumulate(G - j * e, axis=1)[:, :-1] \
            + j[1:] * e + o
        H = np.minimum(G, F)
        clip(i, H)
        at = plen == i
        out[at] = H[rows, tlen][at]
    return np.minimum(out, INF)


def solve(batch, config: dict, precision: str = PRECISION,
          counts: Optional[dict] = None) -> List[Tuple[np.ndarray]]:
    """(score,) of every pair of `batch` under the configuration's
    penalties, the DP whole or, at a control precision, banded.
    `counts`, when a dict, gets `anchors`, the pairs' bases."""
    s = scores(batch, config["x"], config["o"], config["e"],
               _band(precision))
    if counts is not None:
        counts["anchors"] = counts.get("anchors", 0) + len(batch.pat) \
            + len(batch.txt)
    return [(np.array([v]),) for v in s.tolist()]


def wavefront_offsets(smax: int, x: int, o: int, e: int) -> np.ndarray:
    """(smax + 1,): the M, I and D offsets complete-wavefront WFA
    computes for the scores 0..s, for every s.  Wavefront s is computed
    where one of its sources M[s - x], M[s - o - e], I[s - e], D[s - e]
    exists; I and D where M[s - o - e] or their own s - e exists; all
    three over lo - 1 .. hi + 1 of the sources that exist
    (`affine_wavefront_align.c:87-110`), from M[0] = {0}, so the span
    is -hi..hi and follows from the score and the penalties alone."""
    if min(x, e) < 1 or o < 0:
        raise ValueError("penalties need x >= 1, e >= 1 and o >= 0")
    m, g = np.zeros(smax + 1, bool), np.zeros(smax + 1, bool)  # M; I and D
    hi = np.full(smax + 1, -1, np.int64)
    m[0], hi[0] = True, 0
    cells = np.zeros(smax + 1, np.int64)
    cells[0] = 1
    for s in range(1, smax + 1):
        src = [(m, s - x), (m, s - o - e), (g, s - e)]
        have = [t for a, t in src if t >= 0 and a[t]]
        if not have:
            continue
        hi[s] = max(hi[t] for t in have) + 1
        m[s] = True
        g[s] = (s - o - e >= 0 and m[s - o - e]) or (s - e >= 0 and g[s - e])
        cells[s] = (2 * hi[s] + 1) * (1 + 2 * int(g[s]))
    return np.cumsum(cells)


class Work(dict):
    """A batch's work as `work` counts it.  `wf_cells` and `wfa_bound_s`
    need every pair's optimal score, the whole DP, which no answer of
    the run needs: they are computed at their first read (the traced
    run's `wfa_roofline` and `wfa_window_mfu`, after the window), not
    in the set-up."""

    LAZY = ("wf_cells", "wfa_bound_s")

    def __init__(self, batch, config: dict, **counts):
        super().__init__(counts)
        self._batch, self._config = batch, config

    def __missing__(self, key: str):
        if key not in self.LAZY:
            raise KeyError(key)
        self.update(bound(self._batch, self._config))
        return self[key]


def bound(batch, config: dict) -> dict:
    """The wavefront offsets of every pair at its optimal score
    (`wf_cells`) and the least time the card could take for the batch
    (`wfa_bound_s`): the larger of the offsets' operations and of each
    base read once and a score a pair written once."""
    x, o, e = config["x"], config["o"], config["e"]
    s = scores(batch, x, o, e)
    wf = int(wavefront_offsets(int(s.max(initial=0)), x, o, e)[s].sum())
    bases = len(batch.pat) + len(batch.txt)
    return {"wf_cells": wf, "wfa_bound_s": max(
        wf * config["ops_per_wavefront_cell"] / PEAK_INT32_OPS_PER_S,
        (bases * config["bytes_per_base"]
         + len(batch) * config["bytes_per_pair"]) / PEAK_BYTES_PER_S)}


def work(batch, config: dict) -> Work:
    """A batch's work as the reference counts it: its pairs, its bases
    (`anchors`), the equivalent full-DP cells Σ |pattern| x |text|
    (`cells`, the count of `kernels/wfa.py::cell_updates`), and, read
    when asked for, `bound`'s `wf_cells` and `wfa_bound_s`."""
    plen = batch.p_offs[1:] - batch.p_offs[:-1]
    tlen = batch.t_offs[1:] - batch.t_offs[:-1]
    return Work(batch, config, records=len(batch),
                anchors=len(batch.pat) + len(batch.txt),
                cells=int((plen * tlen).sum()))
