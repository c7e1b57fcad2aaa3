"""abea: adaptive banded event alignment (f5c/nanopolish eventalign) as
torch ops.

Reference semantics: abea/src. Scrappie event detection (the
two-window t-statistic peak detector, events.c:280-470; detect_events
:505-550; getevents :552-568, whose trim call discards its result, so
detection runs over the whole raw signal), method-of-moments scaling
(align.c:49-97), and the Suzuki-Kasahara adaptive banded DP
(align.c:169-550): bandwidth 100, the band placed by the ll < ur rule,
float32 scores with double transition penalties, tie priority L > U > D
(:375-385), the trailing-event trim in the backtrace's start
(:411-433), and QC (mean emission >= -5, spanned, largest gap <= 50)
that empties a failed alignment.  Pore model: a 4096-row 6-mer table
(nanopolish's model.h/set_model), loaded from a file.

The design is the JAX package's (kernels/abea.py), which has no Pallas
kernel:
  * event detection, scaling and the eventalign rows stay on the host,
    in numpy, with the peak finder in C (`native/peak_detect.c`);
  * the banded DP runs in lock-step over a batch of reads: one step
    computes the next (B, 100) band of every read;
  * the backtrace runs on the card too, in lock-step, so only the
    (B, T) trace codes and a few numbers a read come back.
Every reference float32 operation is an f64 operation followed by an
f32 cast, each its own torch op, so nothing can be contracted into an
FMA; sums of a band value, an f64 penalty and an emission are f64 and
round to f32 once.  torch computes a Python float or a 0-dim float64
tensor against a float32 tensor in float32, where JAX under x64 computes
in float64, so every mixed operation casts its tensor side to f64 first.

What differs from JAX: both loops run in blocks of BLOCK steps.  A step
(`_band_step`, `_bt_step`) updates its carry tensors in place and writes
its outputs at a slot held in a device tensor, with no read back to the
host and no shape that depends on the data, so on the card one block is
captured as a CUDA graph and replayed for the rest (a graph launch a
block in place of about 90 kernel launches a step); on the CPU the same
block runs eagerly.  The band buffers are padded to a whole number of
blocks, and every read of them is clamped to the true last band, so the
padding steps write only padding; the backtrace reads its `fin` flags
once a block, and its steps past the last lane's end change nothing.
The neighbour bands are gathers from -inf-padded copies of the previous
two bands (JAX's shift-selects); the backtrace takes each k-mer's model
terms from the band scan's per-read tables, which are the same
expressions.  The mesh (`align_batch(mesh=)`) is not ported.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.blocks import run_blocks
from genarchbench_tpu_torch.core.roi import Laps, ROITimer, span
from genarchbench_tpu_torch.sharding.mesh import (Mesh, data_mesh, device_scope,
                                                  mesh_devices, shard_items)

KMER = 6
BANDWIDTH = 100
HALF_BW = 50

# event detection defaults (events.c:42-46)
WIN1, WIN2 = 3, 6
THRESH1, THRESH2 = 1.4, 9.0
PEAK_HEIGHT = 0.2

BLOCK = 32          # loop steps a block (a CUDA graph's length; 32 beat
                    # 64 and 128 on the H100, PERF.md)
C_T1 = float(np.float32(-0.918938))   # log_normal_pdf's constants as the
C_HALF = float(np.float32(-0.5))      # reference's float32 literals


# ---------------------------------------------------------------------------
# pore model
# ---------------------------------------------------------------------------

def load_model(path: str) -> Dict[str, np.ndarray]:
    """2+ column text file: level_mean level_stdv per 6-mer rank
    (nanopolish .model files with headers are also accepted)."""
    means, stdvs = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or not _isfloat(parts[0]):
                if len(parts) > 1 and _isfloat(parts[1]):
                    parts = parts[1:]       # kmer-first format
                else:
                    continue
            means.append(float(parts[0]))
            stdvs.append(float(parts[1]))
    if len(means) != 4 ** KMER:
        raise ValueError(f"model has {len(means)} entries, want 4096")
    lm = np.asarray(means, np.float32)
    ls = np.asarray(stdvs, np.float32)
    return {"level_mean": lm, "level_stdv": ls,
            "level_log_stdv": np.log(ls.astype(np.float64)).astype(
                np.float32)}


def _isfloat(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


_RANK = np.full(256, 0, np.int64)
for _i, _c in enumerate("ACGT"):
    _RANK[ord(_c)] = _i


def kmer_ranks(seq: str) -> np.ndarray:
    """get_kmer_rank for every kmer start (align.c:27-38): base at
    offset j contributes rank << 2*(k-1-j)."""
    codes = _RANK[np.frombuffer(seq.encode(), np.uint8)]
    n = len(seq) - KMER + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    r = np.zeros(n, np.int64)
    for j in range(KMER):
        r += codes[j:j + n] << (2 * (KMER - 1 - j))
    return r


# ---------------------------------------------------------------------------
# event detection (host, exact float semantics of events.c)
# ---------------------------------------------------------------------------

def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, n: int,
                  w: int) -> np.ndarray:
    tstat = np.zeros(n, np.float32)
    if n < 2 * w or w < 2:
        return tstat
    i = np.arange(w, n - w + 1)
    sum1 = sums[i].copy()
    sumsq1 = sumsqs[i].copy()
    big = i > w
    sum1[big] -= sums[i[big] - w]
    sumsq1[big] -= sumsqs[i[big] - w]
    sum2 = (sums[i + w] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w] - sumsqs[i]).astype(np.float32)
    wf = np.float32(w)
    # C promotion semantics: sumsq1/w stays double; mean1*mean1,
    # sumsq2/w, mean2*mean2 are float products/quotients promoted to
    # double in the sum; the result truncates to float at assignment
    mean1 = (sum1 / np.float64(wf)).astype(np.float32)
    mean2 = sum2 / wf
    t2 = (mean1 * mean1).astype(np.float64)
    t3 = (sumsq2 / wf).astype(np.float64)
    t4 = (mean2 * mean2).astype(np.float64)
    comb = ((sumsq1 / np.float64(wf) - t2) + t3 - t4).astype(np.float32)
    comb = np.maximum(comb, np.float32(np.finfo(np.float32).tiny))
    # fabs promotes to double; combined_var/w is a FLOAT division,
    # its sqrt and the final division run in double, then truncate
    num = np.abs((mean2 - mean1).astype(np.float64))
    den = np.sqrt((comb / wf).astype(np.float64))
    t = (num / den).astype(np.float32)
    # the C boundary fudge zeroes [0,w) and (n-w, n) BEFORE the main
    # loop, which then writes every i in [w, n-w] inclusive
    tstat[w:n - w + 1] = t
    return tstat


def _peak_detect(tstat1: np.ndarray, tstat2: np.ndarray) -> np.ndarray:
    """short_long_peak_detector (events.c:370-470) — sequential state
    machine, one pass over samples.  The plain version of
    `native.peak_detect`."""
    n = len(tstat1)
    peaks = np.zeros(n, np.int64)
    pc = 0
    det = [dict(sig=tstat1, thr=THRESH1, wl=WIN1, masked=0, pos=-1,
                val=np.float32(np.finfo(np.float32).max), valid=False),
           dict(sig=tstat2, thr=THRESH2, wl=WIN2, masked=0, pos=-1,
                val=np.float32(np.finfo(np.float32).max), valid=False)]
    FLTMAX = np.float32(np.finfo(np.float32).max)
    for i in range(n):
        for k in (0, 1):
            d = det[k]
            if d["masked"] >= i:
                continue
            cur = d["sig"][i]
            if d["pos"] == -1:
                if cur < d["val"]:
                    d["val"] = cur
                elif cur - d["val"] > PEAK_HEIGHT:
                    d["val"] = cur
                    d["pos"] = i
            else:
                if cur > d["val"]:
                    d["val"] = cur
                    d["pos"] = i
                if k == 0 and d["val"] > d["thr"]:
                    det[1]["masked"] = d["pos"] + d["wl"]
                    det[1]["pos"] = -1
                    det[1]["val"] = FLTMAX
                    det[1]["valid"] = False
                if d["val"] - cur > PEAK_HEIGHT and d["val"] > d["thr"]:
                    d["valid"] = True
                if d["valid"] and (i - d["pos"]) > d["wl"] // 2:
                    peaks[pc] = d["pos"]
                    pc += 1
                    d["pos"] = -1
                    d["val"] = cur
                    d["valid"] = False
    return peaks


def get_events(raw: np.ndarray) -> np.ndarray:
    """getevents (events.c:552-568): returns (n, 4) float64 columns
    (start, length, mean, stdv).  The reference's trim call has no
    effect (struct passed by value), so detection covers all samples."""
    raw = raw.astype(np.float32)
    n = len(raw)
    sums = np.zeros(n + 1, np.float64)
    sumsqs = np.zeros(n + 1, np.float64)
    np.cumsum(raw.astype(np.float64), out=sums[1:])
    # C squares in float32 (data[i]*data[i] is a float product,
    # events.c:293-299) before accumulating in double
    np.cumsum((raw * raw).astype(np.float64), out=sumsqs[1:])
    t1 = compute_tstat(sums, sumsqs, n, WIN1)
    t2 = compute_tstat(sums, sumsqs, n, WIN2)
    found = native.peak_detect(t1, t2, THRESH1, THRESH2, WIN1, WIN2,
                               PEAK_HEIGHT)
    peaks = np.zeros(n, np.int64)
    peaks[:len(found)] = found

    # create_events (events.c:455-500): k = #valid peaks + 1 events;
    # event 0 = [0, peaks[0]), event i = [peaks[i-1], peaks[i]),
    # last = [peaks[k-2], nsample); the per-event mean/stdv math is
    # float32 like the C (vectorized, bit-identical to the loop form)
    nvalid = int(((peaks > 0) & (peaks < n)).sum())
    k = nvalid + 1
    plist = peaks[:max(k - 1, 1)]
    if k == 1:
        starts = np.array([0], np.int64)
        ends = np.array([n], np.int64)
    else:
        starts = np.concatenate([[0], plist[:k - 1]])[:k]
        ends = np.concatenate([plist[:k - 1], [n]])[:k]
    length = (ends - starts).astype(np.float32)
    mean = (sums[ends] - sums[starts]).astype(np.float32) / length
    deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
    var = deltasqr / length - mean * mean
    stdv = np.sqrt(np.maximum(var, np.float32(0)))
    ev = np.zeros((k, 4), np.float64)
    ev[:, 0] = starts
    ev[:, 1] = length
    ev[:, 2] = mean
    ev[:, 3] = stdv
    return ev


def estimate_scalings(seq: str, events: np.ndarray,
                      model) -> Tuple[float, float]:
    """estimate_scalings_using_mom (align.c:49-97)."""
    ranks = kmer_ranks(seq)
    lm = model["level_mean"].astype(np.float64)[ranks]
    event_means = events[:, 2]
    shift = event_means.mean() - lm.mean()
    scale = (((event_means - shift) ** 2).mean()) / ((lm * lm).mean())
    return np.float32(shift), np.float32(scale)


# ---------------------------------------------------------------------------
# adaptive banded DP (device, lock-step over a batch of reads)
# ---------------------------------------------------------------------------

def padded_bands(NB: int, block: int) -> int:
    """Band slots of the output buffers: the first two bands and a whole
    number of `block`-step blocks covering bands 2 .. NB-1."""
    return 2 + block * math.ceil((NB - 2) / block)


def _model_tables(ranks, shift, scale, lm, lsd, llsd) -> torch.Tensor:
    """(B, 3, NK) float32: each k-mer's expected mean (scaled and
    shifted), stdv and -0.918938 - log stdv, the terms of
    log_probability_match_r9 (align.c:109-144; abea.py:277-282)."""
    kr = ranks.long().clamp(0, 4095)
    t = (scale[:, None].double() * lm[kr].double()).float()
    gp_mean = (t.double() + shift[:, None].double()).float()
    t1 = (C_T1 - llsd[kr].double()).float()
    return torch.stack([gp_mean, lsd[kr], t1], 1)


def _emission(em, gp_mean, gp_stdv, t1) -> torch.Tensor:
    """log_probability_match_r9's float32 log-probability (align.c:
    99-144) of event means em under k-mers of expected mean gp_mean,
    stdv gp_stdv and t1 = -0.918938 - log stdv: each float32 op an f64
    op and a cast (abea.py:375-379, 477-484)."""
    d = em - gp_mean                                      # f32 - f32
    a = (d.double() / gp_stdv.double()).float()
    a64 = a.double()
    t2 = (C_HALF * a64).float()
    t2 = (t2.double() * a64).float()
    return (t1.double() + t2.double()).float()


class _BandState:
    """The band scan's carry and outputs; `_band_step` updates it in
    place, so one block of steps can be captured and replayed."""

    def __init__(self, ranks, ev_mean, n_events, n_kmers, shift, scale, lm,
                 lsd, llsd, lp_skip, lp_stay, lp_step, lp_trim, NB, block):
        B, W = ranks.shape[0], BANDWIDTH
        dev = ranks.device
        i64 = torch.int64
        self.ev_mean = ev_mean
        self.tables = _model_tables(ranks, shift, scale, lm, lsd, llsd)
        self.n_events = n_events.long()
        self.ev_last = self.n_events - 1
        self.n_kmers = n_kmers.long()
        self.lp_skip, self.lp_stay, self.lp_step = (
            lp[:, None] for lp in (lp_skip, lp_stay, lp_step))
        self.lp_trim = lp_trim
        self.offs = torch.arange(W, dtype=i64, device=dev)[None, :]
        # gather columns of the -inf-padded previous band: up (j + 1 +
        # right) then left (j + right)
        self.ul_base = torch.cat([self.offs + 1, self.offs], 1)
        self.moves = torch.tensor([[1, 0], [0, 1]], dtype=i64, device=dev)

        NBp = padded_bands(NB, block)
        self.bands = torch.empty((NBp, B, W), dtype=torch.float32,
                                 device=dev)
        self.traces = torch.empty((NBp, B, W), dtype=torch.uint8, device=dev)
        self.blls = torch.empty((NBp, B, 2), dtype=torch.int32, device=dev)
        self.bands[:2] = -math.inf
        self.bands[0, :, HALF_BW] = 0.0
        self.bands[1, :, HALF_BW] = lp_trim.float()
        self.traces[:2] = 0
        self.traces[1, :, HALF_BW] = 1
        bll0 = torch.tensor([HALF_BW - 1, -1 - HALF_BW], dtype=i64,
                            device=dev).expand(B, 2)
        self.blls[0] = bll0
        self.blls[1] = bll0 + self.moves[0]
        # the two previous bands with a -inf column on either side
        self.prev = torch.full((B, W + 2), -math.inf, device=dev)
        self.prev2 = self.prev.clone()
        self.prev[:, 1:W + 1] = self.bands[1]
        self.prev2[:, 1:W + 1] = self.bands[0]
        self.bll = self.blls[1].long()                 # (e, k) of band b-1
        self.bll2 = self.blls[0].long()                # and of band b-2
        # the event window em_w[:, j] = ev_mean[e - j] and the k-mer
        # windows kw[:, :, j] = tables[k + j] of band b-1, clamped
        e_idx = (self.bll[:, :1] - self.offs).clamp(0, ev_mean.shape[1] - 1)
        self.em_w = ev_mean.gather(1, e_idx)
        k_idx = (self.bll[:, 1:] + self.offs).clamp(
            0, self.tables.shape[2] - 1)
        self.kw = self.tables.gather(2, k_idx[:, None, :].expand(B, 3, W))
        self.b = torch.tensor(2, dtype=i64, device=dev)   # band to compute


def _band_step(s: _BandState) -> None:
    """One Suzuki-Kasahara band advance for every read (abea.py:304-399).
    The band moves right (k + 1) or down (e + 1); the event and k-mer
    windows slide by at most one, taking one gathered element each."""
    W = BANDWIDTH
    B, NE = s.ev_mean.shape
    NK = s.tables.shape[2]
    ll, ur = s.prev[:, 1], s.prev[:, W]
    # both band ends out of band: right on odd b (abea.py:314-318)
    right = torch.where(torch.isinf(s.prev[:, 1::W - 1]).all(1),
                        s.b % 2 == 1, ll < ur)
    rr = right.long()
    bll = s.bll + s.moves[rr]                 # (e, k) of band b
    e2, k2 = bll[:, 0], bll[:, 1]
    rc = right[:, None]

    # slide the event window on down moves, the k-mer windows on right
    inc = s.ev_mean.gather(1, e2.clamp(0, NE - 1)[:, None])
    em_w = torch.where(rc, s.em_w, torch.cat([inc, s.em_w[:, :-1]], 1))
    k_in = (k2 + (W - 1)).clamp(0, NK - 1)[:, None, None].expand(B, 3, 1)
    inc = s.tables.gather(2, k_in)
    kw = torch.where(rc[:, :, None], torch.cat([s.kw[:, :, 1:], inc], 2),
                     s.kw)

    # the trim cell: offs == t_off already puts t_off inside the band
    t_off = -1 - k2
    t_evt = e2 - t_off
    t_ok = (t_evt >= 0) & (t_evt < s.n_events)
    t_val = (s.lp_trim * (t_evt + 1).double()).float()
    sel = (s.offs == t_off[:, None]) & t_ok[:, None]

    lo = torch.maximum(-k2, e2 - s.ev_last).clamp_min(0)
    hi = torch.minimum(s.n_kmers - k2, e2 + 1).clamp_max(W)
    inrange = (s.offs >= lo[:, None]) & (s.offs < hi[:, None])

    # neighbour bands: up = right ? prev[j+1] : prev[j], left = right ?
    # prev[j] : prev[j-1], diag = prev2 shifted by k2 - k(b-2) - 1
    ul = s.prev.gather(1, s.ul_base + rr[:, None])
    up, left = ul[:, :W], ul[:, W:]
    diag = s.prev2.gather(1, s.offs + (k2 - s.bll2[:, 1])[:, None])

    em64 = _emission(em_w, kw[:, 0], kw[:, 1], kw[:, 2]).double()
    sd = (diag.double() + s.lp_step + em64).float()
    su = (up.double() + s.lp_stay + em64).float()
    sl = (left.double() + s.lp_skip).float()

    # max with trace codes, ties L > U > D (0 diag, 1 up, 2 left)
    mx2 = torch.maximum(sd, su)
    fr = (mx2 == su).to(torch.uint8)
    mx3 = torch.maximum(mx2, sl)
    fr = torch.where(mx3 == sl, 2, fr)

    band = torch.where(inrange, mx3, torch.where(sel, t_val[:, None],
                                                 -math.inf))
    trace = torch.where(inrange, fr, sel.to(torch.uint8))

    slot = s.b.view(1)
    s.bands.index_copy_(0, slot, band[None])
    s.traces.index_copy_(0, slot, trace[None])
    s.blls.index_copy_(0, slot, bll.int()[None])
    s.prev2.copy_(s.prev)
    s.prev[:, 1:W + 1].copy_(band)
    s.bll2.copy_(s.bll)
    s.bll.copy_(bll)
    s.em_w.copy_(em_w)
    s.kw.copy_(kw)
    s.b.add_(1)


def _band_scan(ranks, ev_mean, n_events, n_kmers, shift, scale, lm, lsd,
               llsd, lp_skip, lp_stay, lp_step, lp_trim, NB, block, graphed,
               counts=None):
    """The band scan over padded buffers: (bands, traces, blls) with
    padded_bands(NB, block) slots, of which the first NB are the
    result."""
    s = _BandState(ranks, ev_mean, n_events, n_kmers, shift, scale, lm, lsd,
                   llsd, lp_skip, lp_stay, lp_step, lp_trim, NB, block)

    def run_block():
        for _ in range(block):
            _band_step(s)

    n_blocks = (s.bands.shape[0] - 2) // block
    ran = run_blocks(run_block, n_blocks, graphed, device=ranks.device)
    if counts is not None:
        counts.update(band_steps=NB - 2, band_blocks=ran)
    return s.bands, s.traces, s.blls


def band_scan(ranks, ev_mean, n_events, n_kmers, shift, scale, lm, lsd,
              llsd, lp_skip, lp_stay, lp_step, lp_trim, NB, NE, NK):
    """The adaptive banded DP of a batch of reads on their device
    (`_band_scan_device`, abea.py:253-413): ranks (B, NK) int; ev_mean
    (B, NE) f32; n_events, n_kmers (B,); shift, scale (B,) f32; lm, lsd,
    llsd (4096,) f32; lp_* (B,) f64.  Returns bands (NB, B, 100) f32,
    traces (NB, B, 100) uint8 and blls (NB, B, 2) int32, each band's
    lower-left (event, k-mer)."""
    if ev_mean.shape[1] != NE or ranks.shape[1] != NK:
        raise ValueError(f"ranks and ev_mean must be (B, {NK}) and "
                         f"(B, {NE}), got {tuple(ranks.shape)} and "
                         f"{tuple(ev_mean.shape)}")
    bands, traces, blls = _band_scan(
        ranks, ev_mean, n_events, n_kmers, shift, scale, lm, lsd, llsd,
        lp_skip, lp_stay, lp_step, lp_trim, NB, BLOCK, ranks.is_cuda)
    return bands[:NB], traces[:NB], blls[:NB]


class _BtState:
    """The backtrace's carry (abea.py:456-510), updated in place by
    `_bt_step`; fr_out has a spare column T for steps at t >= T."""

    def __init__(self, bands, traces, blls, ranks, ev_mean, n_ev, n_km,
                 shifts, scales, lm, lsd, llsd, lp_trim, NB, T):
        B, W = ranks.shape[0], BANDWIDTH
        dev = ranks.device
        i64 = torch.int64
        self.traces_f = traces.reshape(-1)
        self.blls_f = blls.reshape(-1)
        self.ev_mean = ev_mean
        self.tables = _model_tables(ranks, shifts, scales, lm, lsd, llsd)
        self.lane = torch.arange(B, dtype=i64, device=dev)
        self.NB, self.T = NB, T
        n_ev, n_km = n_ev.long(), n_km.long()

        # start (align.c:430-447): the event ei maximizing bands[ei + nk
        # + 1][bll - ei] + (ne - ei) * lp_trim, summed in f64 and
        # rounded once; the first maximum wins (torch.argmax, like JAX)
        NE = ev_mean.shape[1]
        eis = torch.arange(NE, dtype=i64, device=dev)[None, :]
        row = (eis + n_km[:, None] + 1).clamp(0, NB - 1) * B \
            + self.lane[:, None]
        off_s = self.blls_f[row * 2].long() - eis
        ok_s = (off_s >= 0) & (off_s < W) & (eis < n_ev[:, None])
        val_s = bands.reshape(-1)[row * W + off_s.clamp(0, W - 1)]
        score_s = (val_s.double() + (n_ev[:, None] - eis).double()
                   * lp_trim[:, None].double()).float()
        self.e0 = torch.argmax(torch.where(ok_s, score_s, -math.inf), 1)

        z = torch.zeros(B, dtype=i64, device=dev)
        self.ck = n_km - 1
        self.ce = self.e0.clone()
        self.gap, self.mgap, self.n_al = z.clone(), z.clone(), z.clone()
        self.sum_em = torch.zeros(B, dtype=torch.float64, device=dev)
        self.k_last = torch.full((B,), -1, dtype=i64, device=dev)
        self.fin = (self.ck < 0) | (self.ce < 0)
        self.t = torch.tensor(0, dtype=i64, device=dev)
        self.fr_out = torch.full((B, T + 1), 255, dtype=torch.uint8,
                                 device=dev)


def _bt_step(s: _BtState) -> None:
    """One trace-code step of every lane (abea.py:458-501), with the
    emission QC sums; a finished lane's step changes nothing."""
    W = BANDWIDTH
    B, NE = s.ev_mean.shape
    NK = s.tables.shape[2]
    act = ~s.fin & (s.ck >= 0) & (s.ce >= 0)
    k_last = torch.where(act, s.ck, s.k_last)
    row = (s.ce + s.ck + 2).clamp(0, s.NB - 1) * B + s.lane
    off = s.blls_f[row * 2].long() - s.ce
    fr = s.traces_f[row * W + off.clamp(0, W - 1)]

    kw = s.tables.gather(2, s.ck.clamp(0, NK - 1)[:, None, None]
                         .expand(B, 3, 1))[:, :, 0]
    em = s.ev_mean.gather(1, s.ce.clamp(0, NE - 1)[:, None])[:, 0]
    lp = _emission(em, kw[:, 0], kw[:, 1], kw[:, 2])
    sum_em = torch.where(act, s.sum_em + lp.double(), s.sum_em)

    s.fr_out.index_copy_(1, s.t.clamp(max=s.T).view(1),
                         torch.where(act, fr, 255)[:, None])
    dk = act & (fr != 1)
    de = act & (fr != 2)
    gap = torch.where(act & (fr == 2), s.gap + 1, torch.where(act, 0, s.gap))
    ck = s.ck - dk.long()
    ce = s.ce - de.long()
    s.fin.copy_(s.fin | ~act | (ck < 0) | (ce < 0))
    s.mgap.copy_(torch.maximum(s.mgap, gap))
    s.gap.copy_(gap)
    s.n_al.add_(act.long())
    s.sum_em.copy_(sum_em)
    s.k_last.copy_(k_last)
    s.ck.copy_(ck)
    s.ce.copy_(ce)
    s.t.add_(1)


def _backtrace(bands, traces, blls, ranks, ev_mean, n_ev, n_km, shifts,
               scales, lm, lsd, llsd, lp_trim, NB, T, block, graphed,
               counts=None):
    s = _BtState(bands, traces, blls, ranks, ev_mean, n_ev, n_km, shifts,
                 scales, lm, lsd, llsd, lp_trim, NB, T)

    def run_block():
        for _ in range(block):
            _bt_step(s)

    n_blocks = math.ceil(T / block)
    ran = run_blocks(run_block, n_blocks, graphed,
                      done=lambda: bool(s.fin.all()), device=ranks.device)
    if counts is not None:
        counts.update(bt_steps=ran * block, bt_blocks=ran)
    return (s.fr_out[:, :T], s.e0, s.n_al, s.sum_em, s.mgap, s.k_last)


def backtrace(bands, traces, blls, ranks, ev_mean, n_ev, n_km, shifts,
              scales, lm, lsd, llsd, lp_trim, NB, NE, NK, T):
    """The lock-step device backtrace (`_abea_backtrace_device`,
    abea.py:416-513) over band_scan's outputs: returns fr_out (B, T)
    uint8 trace codes in walk order (255 past a lane's end), e0, n_al,
    sum_em (f64), mgap and k_last (B,)."""
    if ev_mean.shape[1] != NE or ranks.shape[1] != NK:
        raise ValueError(f"ranks and ev_mean must be (B, {NK}) and "
                         f"(B, {NE}), got {tuple(ranks.shape)} and "
                         f"{tuple(ev_mean.shape)}")
    return _backtrace(bands, traces, blls, ranks, ev_mean, n_ev, n_km,
                      shifts, scales, lm, lsd, llsd, lp_trim, NB, T, BLOCK,
                      ranks.is_cuda)


def _host_inputs(seqs: List[str], event_tables: List[np.ndarray], model):
    """align_batch's host arrays, as JAX builds them (abea.py:525-554):
    (arrays by name, NB, NE, NK)."""
    B = len(seqs)
    n_ev = np.ones(B, np.int32)
    n_km = np.ones(B, np.int32)
    n_ev[:] = [len(e) for e in event_tables]
    n_km[:] = [len(s) - KMER + 1 for s in seqs]
    NE = 1 << int(max(n_ev.max(), 1) - 1).bit_length()
    NK = 1 << int(max(n_km.max(), 1) - 1).bit_length()
    NB = int((n_ev + n_km).max()) + 2

    ranks = np.zeros((B, NK), np.int32)
    ev_mean = np.zeros((B, NE), np.float32)
    shifts = np.zeros(B, np.float32)
    scales = np.ones(B, np.float32)
    lps = np.zeros((B, 4), np.float64)   # skip, stay, step, trim
    for i, (s, et) in enumerate(zip(seqs, event_tables)):
        ranks[i, :n_km[i]] = kmer_ranks(s)
        ev_mean[i, :n_ev[i]] = et[:, 2].astype(np.float32)
        sh, sc = estimate_scalings(s, et, model)
        shifts[i], scales[i] = sh, sc
        epk = float(n_ev[i]) / float(n_km[i])
        p_stay = 1 - (1 / (epk + 1))
        lp_skip = np.log(1e-10)
        lp_stay = np.log(p_stay)
        lp_step = np.log(1.0 - np.exp(lp_skip) - np.exp(lp_stay))
        lps[i] = (lp_skip, lp_stay, lp_step, np.log(0.01))
    arrays = dict(ranks=ranks, ev_mean=ev_mean, n_ev=n_ev, n_km=n_km,
                  shifts=shifts, scales=scales,
                  lm=np.asarray(model["level_mean"], np.float32),
                  lsd=np.asarray(model["level_stdv"], np.float32),
                  llsd=np.asarray(model["level_log_stdv"], np.float32),
                  lps=np.ascontiguousarray(lps.T))
    return arrays, NB, NE, NK


def _to_device(arrays: Dict[str, np.ndarray], dev: torch.device):
    """The arrays as tensors on dev through one copy of one byte blob."""
    offs, n = [], 0
    for a in arrays.values():
        offs.append(n)
        n += -(-a.nbytes // 8) * 8
    blob = np.zeros(n, np.uint8)
    for o, a in zip(offs, arrays.values()):
        blob[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    blob_t = torch.from_numpy(blob).to(dev)
    return {k: blob_t[o:o + a.nbytes].view(getattr(torch, a.dtype.name))
            .view(a.shape) for (k, a), o in zip(arrays.items(), offs)}


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays through one copy of one byte blob."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    blob = torch.cat(flat).cpu().numpy()
    out, o = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(blob[o:o + n].view(
            getattr(np, str(t.dtype).split(".")[1])).reshape(t.shape))
        o += n
    return out


def _align(seqs: List[str], event_tables: List[np.ndarray], model,
           dev: torch.device, stats: Optional[dict] = None,
           graphed: bool = True):
    """align_batch on dev; graphed=False runs the blocks eagerly on the
    card as well (the comparison chip_smoke.py makes)."""
    graphed = graphed and dev.type == "cuda"
    lap = Laps(stats, dev)
    host, NB, NE, NK = _host_inputs(seqs, event_tables, model)
    lap("prep_s")
    d = _to_device(host, dev)
    lap("h2d_s")
    counts = {}
    args = (d["ranks"], d["ev_mean"], d["n_ev"], d["n_km"], d["shifts"],
            d["scales"], d["lm"], d["lsd"], d["llsd"])
    with span("abea.band"):
        bands, traces, blls = _band_scan(*args, *d["lps"], NB, BLOCK, graphed,
                                         counts)
    lap("band_s")
    with span("abea.backtrace"):
        out = _backtrace(bands, traces, blls, *args, d["lps"][3], NB, NB,
                         BLOCK, graphed, counts)
    lap("backtrace_s")
    fr_out, e0, n_al, sum_em, mgap, k_last = _to_host(out)
    lap("d2h_s")
    results = _pairs(fr_out, e0, n_al, sum_em, mgap, k_last, host["n_km"])
    lap("pairs_s")
    if stats is not None:
        stats.update(counts, nb=NB, ne=NE, nk=NK, block=BLOCK,
                     graphed=graphed)
    return results


def _pairs(fr_out, e0, n_al, sum_em, mgap, k_last, n_km):
    """Each read's (kmer_idx, event_idx) pairs from the backtrace's
    outputs, empty where QC fails (abea.py:586-603)."""
    results = []
    for i in range(len(n_km)):
        nal = int(n_al[i])
        if nal == 0:
            results.append([])
            continue
        frs = fr_out[i, :nal].astype(np.int32)
        dk = (frs != 1).astype(np.int32)
        de = (frs != 2).astype(np.int32)
        ks = (n_km[i] - 1) - (np.cumsum(dk) - dk)    # k before each move
        es = int(e0[i]) - (np.cumsum(de) - de)
        avg = float(sum_em[i]) / nal
        spanned = int(k_last[i]) == 0 and int(ks[0]) == n_km[i] - 1
        if avg < -5.0 or not spanned or int(mgap[i]) > 50:
            results.append([])
            continue
        results.append(list(zip(ks[::-1].tolist(), es[::-1].tolist())))
    return results


def align_batch(seqs: List[str], event_tables: List[np.ndarray],
                model, sample_rate: float = 4000.0, *,
                device: Optional[str] = None,
                stats: Optional[dict] = None,
                mesh: Optional[Mesh] = None):
    """Adaptive banded alignment of a batch of reads: per read the list
    of (kmer_idx, event_idx) pairs (empty when QC fails).  The host
    arrays go to the device in one copy, band_scan and backtrace run
    there, and the trace codes come back in one copy.

    `stats`, when a dict, is filled with NB, NE, NK, the block length,
    the band and backtrace steps taken and the blocks run (on the card
    the first block of each loop runs eagerly and the rest are graph
    replays), and the seconds of host preparation, copies, band scan,
    backtrace and pair lists (the card synchronized at each
    boundary).  With a mesh, the reads split over its devices
    (`shard_items`), each shard aligned on its own device with its own
    graphs."""
    devs = mesh_devices(mesh, device)
    if mesh is None:
        return _align(seqs, event_tables, model, devs[0], stats)
    out: list = [None] * len(seqs)
    for dev, part in zip(devs, shard_items(np.arange(len(seqs)), mesh)):
        if not len(part):
            continue
        with device_scope(dev):
            res = _align([seqs[i] for i in part],
                         [event_tables[i] for i in part], model, dev, stats)
        for i, r in zip(part, res):
            out[i] = r
    return out


def backtrace_one(bands, traces, blls, ne, nk, seq, ev_mean, model,
                  shift, scale, lps) -> List[Tuple[int, int]]:
    """align.c's backtrack (:408-545) and QC for one read, on the host
    (`_backtrace_one`, abea.py:606-659): the plain version the tests
    hold the device backtrace to.  bands, traces and blls are the read's
    (NB, 100), (NB, 100) and (NB, 2) slices."""
    lp_skip, lp_stay, lp_step, lp_trim = lps
    curr_k = nk - 1
    max_score = -np.inf
    curr_e = 0
    for ei in range(ne):
        bi = (ei + 1) + (curr_k + 1)
        off = int(blls[bi, 0]) - ei
        if 0 <= off < BANDWIDTH:
            s = float(bands[bi, off]) + (ne - ei) * lp_trim
            if s > max_score:
                max_score = s
                curr_e = ei
    rank_arr = kmer_ranks(seq)
    out = []
    sum_em = 0.0
    n_al = 0
    curr_gap = 0
    max_gap = 0
    while curr_k >= 0 and curr_e >= 0:
        out.append((curr_k, curr_e))
        kr = int(rank_arr[curr_k])
        gp_mean = np.float32(scale * model["level_mean"][kr] + shift)
        gp_stdv = model["level_stdv"][kr]
        a = np.float32((ev_mean[curr_e] - gp_mean) / gp_stdv)
        sum_em += float(np.float32(-0.918938)
                        - model["level_log_stdv"][kr]
                        + np.float32(-0.5) * a * a)
        n_al += 1
        bi = (curr_e + 1) + (curr_k + 1)
        off = int(blls[bi, 0]) - curr_e
        fr = traces[bi, off]
        if fr == 0:
            curr_k -= 1
            curr_e -= 1
            curr_gap = 0
        elif fr == 1:
            curr_e -= 1
            curr_gap = 0
        else:
            curr_k -= 1
            curr_gap += 1
            max_gap = max(curr_gap, max_gap)
    out.reverse()
    if not out:
        return []
    avg = sum_em / max(n_al, 1)
    spanned = out[0][0] == 0 and out[-1][0] == nk - 1
    if avg < -5.0 or not spanned or max_gap > 50:
        return []
    return out


# ---------------------------------------------------------------------------
# eventalign output + CLI
# ---------------------------------------------------------------------------

EVENTALIGN_HEADER = ("contig\tposition\treference_kmer\tread_index\t"
                     "strand\tevent_index\tevent_level_mean\t"
                     "event_stdv\tevent_length\tmodel_kmer\t"
                     "model_mean\tmodel_stdv\tstandardized_level\n")


def write_eventalign(out, contig, ref_start, seq, pairs, events, model,
                     shift, scale, read_index, sample_rate=4000.0):
    """nanopolish-style eventalign rows; the benchmark's tolerant check
    compares columns 3 (reference_kmer) and 10 (model_kmer).  The JAX
    package's row loop (abea.py:672-686) with its arithmetic done on
    whole columns in the same types (model_mean float32, the
    standardized level float64), so every row's bytes are the same."""
    if not pairs:
        return
    ki, ei = np.asarray(pairs, np.int64).T
    ranks = kmer_ranks(seq)
    kr = np.where(ki < len(ranks), ranks[np.minimum(ki, len(ranks) - 1)], 0)
    mm = scale * model["level_mean"][kr] + shift
    ms = model["level_stdv"][kr]
    lv = events[ei, 2]
    std_lv = (lv - mm) / ms
    length = events[ei, 1] / sample_rate
    out.write("".join(
        f"{contig}\t{ref_start + k}\t{seq[k:k + KMER]}\t{read_index}\t"
        f"t\t{e}\t{v:.2f}\t{sd:.3f}\t{n:.5f}\t{seq[k:k + KMER]}\t"
        f"{m:.2f}\t{s:.2f}\t{z:.2f}\n"
        for k, e, v, sd, n, m, s, z in zip(
            ki.tolist(), ei.tolist(), lv.tolist(), events[ei, 3].tolist(),
            length.tolist(), mm.tolist(), ms.tolist(), std_lv.tolist())))


def _load_signal_fn(signals_arg: str):
    """Resolve `-r`: an f5c-indexed reads file (fast5 via
    <reads>.index.readdb, the reference's input contract,
    nanopolish_read_db.c:83-91) or a directory of <qname>.npy arrays."""
    from genarchbench_tpu_torch.io.fast5_io import Fast5Index

    if os.path.isdir(signals_arg):
        def from_dir(qname: str):
            p = os.path.join(signals_arg, f"{qname}.npy")
            if not os.path.exists(p):
                return None
            return np.load(p).astype(np.float32)
        return from_dir
    idx = (Fast5Index(signals_arg)
           if signals_arg.endswith(".readdb")
           else Fast5Index.for_reads(signals_arg))
    return idx.signal


def run(argv: Sequence[str]) -> int:
    """eventalign pipeline: -b bam -g ref.fa -r reads --kmer-model
    model.txt [-o out.tsv].  `-r` takes the f5c form — a reads file with
    `<reads>.index.readdb` beside it locating fast5 signal files
    (abea/README.md:22-28; needs h5py) — or a directory of <qname>.npy
    arrays.

    Batches are double-buffered like the reference's interleaved
    load_db/process_db/output_db pipeline (meth_main.c:12-27,517-570):
    a loader thread reads signals and detects events for batch i+1
    while batch i aligns on the device, and a writer thread writes
    batch i-1's rows."""
    import argparse
    from concurrent.futures import ThreadPoolExecutor
    from genarchbench_tpu_torch.io.bam_io import read_bam
    p = argparse.ArgumentParser(prog="abea")
    p.add_argument("-b", dest="bam", required=True)
    p.add_argument("-g", dest="ref", required=True)
    p.add_argument("-r", dest="signals", required=True)
    p.add_argument("--kmer-model", dest="model", required=True)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-K", dest="batch", type=int, default=512)
    args = p.parse_args(argv)

    dev = resolve_device()
    mesh = data_mesh()
    model = load_model(args.model)
    refs, records = read_bam(args.bam)
    contigs: Dict[str, str] = {}
    with open(args.ref) as f:
        name, cur = None, []
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                if name:
                    contigs[name] = "".join(cur)
                name, cur = line[1:].split()[0], []
            else:
                cur.append(line)
        if name:
            contigs[name] = "".join(cur)

    get_signal = _load_signal_fn(args.signals)
    jobs = []
    for idx, r in enumerate(records):
        if r.flag & 0x904 or r.ref_id < 0:
            continue
        contig = refs[r.ref_id][0]
        span = r.ref_span()
        ref_seq = contigs[contig][r.pos:r.pos + span]
        if len(ref_seq) < KMER:
            continue
        jobs.append((idx, r.qname, contig, r.pos, ref_seq))

    out = open(args.output, "w") if args.output else sys.stdout
    out.write(EVENTALIGN_HEADER)

    def load_batch(b0: int):
        """stage 1 (host): signal load + event detection (load_db +
        event_single's host half)."""
        chunk, evs = [], []
        for job in jobs[b0:b0 + args.batch]:
            raw = get_signal(job[1])
            if raw is None:
                continue
            chunk.append(job)
            evs.append(get_events(raw))
        return chunk, evs

    def emit_batch(chunk, evs, pairs):
        """stage 3 (host): postprocess + eventalign TSV rows
        (output_db, meth_main.c:166-186)."""
        for (idx, _, contig, pos, sq), et, pr in zip(chunk, evs, pairs):
            sh, sc = estimate_scalings(sq, et, model)
            write_eventalign(out, contig, pos, sq, pr, et, model,
                             sh, sc, idx)

    roi = ROITimer("abea", "Data processing time: {t:.3f} sec")
    # the 3-stage pipeline (meth_main.c:12-27,517-570): the loader
    # thread reads batch i+1, the main thread aligns batch i on the
    # device, and the writer thread emits batch i-1
    writes = []
    with roi, ThreadPoolExecutor(max_workers=1) as pool, \
            ThreadPoolExecutor(max_workers=1) as wpool:
        nxt = pool.submit(load_batch, 0) if jobs else None
        for b0 in range(0, len(jobs), args.batch):
            chunk, evs = nxt.result()
            n1 = b0 + args.batch
            nxt = (pool.submit(load_batch, n1)
                   if n1 < len(jobs) else None)
            if not chunk:
                continue
            seqs = [sq for (_, _, _, _, sq) in chunk]
            pairs = align_batch(seqs, evs, model, device=dev, mesh=mesh)
            writes.append(wpool.submit(emit_batch, chunk, evs, pairs))
        for w in writes:            # the writer's errors surface here
            w.result()
    if args.output:
        out.close()
    roi.report()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
