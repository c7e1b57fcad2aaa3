"""minimap2 anchor-chaining DP (exact, with the skip heuristic) as torch ops.

Reference semantics: chain/src/host_kernel.cpp:30-94 (`chain_dp`): for
each anchor i, scan predecessors j = i-1 .. st backwards, score
sc = min(dq, dr, q_span) - gap_cost + scores[j], keep the max (strict >,
so ties keep the largest j), with minimap2's skip heuristic (`n_skip` /
`t[]` markers, break after MAX_SKIP skip hits) reproduced bit-exactly.

The design is the JAX package's (kernels/chain.py), which has no Pallas
kernel, so every step here is torch ops on the device:
  * all records of a plan step through the DP in lock-step, one anchor
    a step, every op a (B, K) tensor over one window per record;
  * the window starts `st` come from the host (a C two-pointer sweep);
  * the f64 gap cost `(int)(dd * .01 * avg_qspan)` is an elementwise
    f32 product made exact by at most CORR_K sparse per-record
    corrections that the host computes in C; records whose corrections
    cannot be bounded go to the exact scalar DP in C;
  * per anchor, the whole window at once: the running max at each j
    is a reversed cumulative max, the n_skip counter a (C, M)
    saturating scan, and the winner the largest j above the break
    reaching the window max.
`_chain_dp_win_device` slides a W-wide window over each row, W being
the plan's widest window rounded up to 32, or the padded length when
that is narrower.  What differs from JAX: one kernel takes every plan
(the JAX dense kernel took the records that its windowed kernel's
ragged packing and child bitmask could not hold, and the port has
neither); the anchor loop's trip count (the plan's largest n) is known
on the host, so the loop never reads from the card; the skip-marker
test "t[j] == i" (some j' already scanned at this anchor has parent j)
is one scatter per step into a (B, K+1) row, where the TPU kept a
shifted child bitmask because its scatters serialize; log2 comes from
the float64 exponent (torch has no clz); x's low 32 bits ride in
int32, whose wrapping difference is the C's `(int32_t)(xl[i] - xl[j])`.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import Laps, ROITimer, count, span
from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.sharding.batching import plan_batches
from genarchbench_tpu_torch.sharding.mesh import (Mesh, data_mesh, device_scope,
                                                  mesh_devices, shard_items)

MAX_SKIP = 25
MAX_ITER = 5000
NEG = -(1 << 30)        # "no candidate" score, below every reachable one

# 4 slots cover p99.9 of records (bench distribution: median 0
# corrections, p99 = 2); records needing more, or with products past
# SAFE_PROD, defer to the exact scalar C DP (native chain_dp_scalar).
CORR_K = 4

# largest product magnitude for which the near-integer window of the
# correction scan (4e-3) provably covers every f32-vs-f64 truncation
# mismatch: the two-op f32 product error is ~V*1.2e-7, so V <= 2^14
# keeps it under ~2e-3 < 4e-3.
SAFE_PROD = 16384.0

# a plan holds at most MAX_BATCH records and CELL_BUDGET padded cells
# (the bench input is one (16384, 512) plan)
MAX_BATCH = 16384
CELL_BUDGET = 1 << 24

i32 = torch.int32
i64 = torch.int64
f32 = torch.float32


def clin_table(avg_qspan: float, size: int) -> np.ndarray:
    """Exact table of (int)(dd * .01 * avg_qspan) computed in f64 like the C
    (host_kernel.cpp:74: double promotion, truncation toward zero)."""
    dd = np.arange(size, dtype=np.float64)
    return (dd * 0.01 * np.float64(np.float32(avg_qspan))).astype(np.int32)


def _flat_decode(xs, ys):
    """The concatenated u64 anchor arrays as flat planes in one pass:
    x_lo (uint32), qi (int32), span (uint8, y bits 32-39) and sid
    (uint8, y bits 48-55)."""
    flat_x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    flat_y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    if sys.byteorder == "little":
        x_lo = np.ascontiguousarray(
            flat_x.view(np.uint32).reshape(-1, 2)[:, 0])
        qi = np.ascontiguousarray(
            flat_y.view(np.uint32).reshape(-1, 2)[:, 0]).view(np.int32)
        yb = flat_y.view(np.uint8).reshape(-1, 8)
        span = np.ascontiguousarray(yb[:, 4])
        sid = np.ascontiguousarray(yb[:, 6])
    else:
        x_lo = (flat_x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        qi = (flat_y & np.uint64(0xFFFFFFFF)).astype(np.uint32) \
            .view(np.int32)
        span = ((flat_y >> np.uint64(32)) & np.uint64(0xFF)) \
            .astype(np.uint8)
        sid = ((flat_y >> np.uint64(48)) & np.uint64(0xFF)) \
            .astype(np.uint8)
    return x_lo, qi, span, sid


def gap_corrections(avg32: np.ndarray, t_size: int, ck: int = CORR_K):
    """Per-record sparse corrections making the device's f32 gap cost
    bit-equal to the C's f64 one for dd in [0, t_size): (corr_dd,
    corr_delta) (nb, ck) int32, corr_dd -1 in unused slots, and `over`
    (nb,) bool, the rows that need more than ck slots or whose largest
    product exceeds SAFE_PROD (they go to the scalar C DP).  Computed in
    C (native/chain.c::chain_gap_corr), which tests only the dd values
    near an integer product; `gap_corrections_plain` is the dense scan
    it is held to."""
    return native.chain_gap_corr(avg32, t_size, ck, SAFE_PROD)


def gap_corrections_plain(avg32: np.ndarray, t_size: int,
                          ck: int = CORR_K):
    """`gap_corrections` by a dense scan of every dd in [0, t_size)."""
    avg32 = np.asarray(avg32, np.float32)
    nb = len(avg32)
    corr_dd = np.full((nb, ck), -1, np.int32)
    corr_delta = np.zeros((nb, ck), np.int32)
    over = avg32.astype(np.float64) * ((t_size - 1) * 0.01) > SAFE_PROD
    dd64 = np.arange(t_size, dtype=np.float64)
    dd32 = np.arange(t_size, dtype=np.float32) * np.float32(0.01)
    for r in np.flatnonzero(~over):
        exact = (dd64 * 0.01 * np.float64(avg32[r])).astype(np.int32)
        appr = (dd32 * avg32[r]).astype(np.int32)
        bad = np.flatnonzero(appr != exact)
        over[r] = len(bad) > ck
        corr_dd[r, :len(bad[:ck])] = bad[:ck]
        corr_delta[r, :len(bad[:ck])] = (exact - appr)[bad[:ck]]
    return corr_dd, corr_delta, over


@dataclasses.dataclass
class ChainPlan:
    """One plan's host arrays.  planes (5, B, N) int32: x's low word
    (uint32 bits), qi, span, sid and the window start st (i for the
    anchors past a row's n, an empty window); per record (B,): n (0 for
    rows deferred to the scalar DP), mdx, mdy, bw, nsegs (int32), avg32
    (float32), and corr_dd / corr_delta (B, CORR_K).  `over` marks the
    deferred rows; W is the kernel's window width, at most N."""
    planes: np.ndarray
    n: np.ndarray
    mdx: np.ndarray
    mdy: np.ndarray
    bw: np.ndarray
    nsegs: np.ndarray
    avg32: np.ndarray
    corr_dd: np.ndarray
    corr_delta: np.ndarray
    over: np.ndarray
    W: int


def pad_planes(recs: Sequence[chain_io.ChainRecord],
               ws: Sequence[np.ndarray], n: np.ndarray, N: int) -> np.ndarray:
    """(5, B, N) int32 planes of the first n[b] anchors of each record:
    x's low word (uint32 bits), qi, span, sid and the window start st,
    which is i past n[b] (an empty window); zeros elsewhere."""
    live = [b for b in range(len(recs)) if n[b]]
    x_lo, qi, span, sid = _flat_decode([recs[b].x for b in live],
                                       [recs[b].y for b in live])
    st = np.concatenate([ws[b] for b in live] + [np.zeros(0, np.int32)])
    iota = np.arange(N, dtype=np.int32)
    mask = iota[None, :] < n[:, None]
    planes = np.zeros((5, len(recs), N), np.int32)
    planes[4] = iota
    for k, v in enumerate((x_lo.view(np.int32), qi, span, sid, st)):
        planes[k][mask] = v
    return planes


def plan_inputs(recs: Sequence[chain_io.ChainRecord],
                ws: Sequence[np.ndarray], N: int) -> ChainPlan:
    """The padded (B, N) inputs of one plan of records with window
    starts `ws`, their gap corrections and window width: the widest
    window rounded up to 32, or N when that is narrower."""
    prm = {k: np.array([getattr(r, a) for r in recs], np.int32)
           for k, a in (("mdx", "max_dist_x"), ("mdy", "max_dist_y"),
                        ("bw", "bw"), ("nsegs", "n_segs"))}
    avg32 = np.array([r.avg_qspan for r in recs], np.float32)
    t_size = int(max(max(r.max_dist_x, r.bw) for r in recs)) + 1
    cdd, cdel, over = gap_corrections(avg32, t_size)
    n = np.array([0 if o else r.n for r, o in zip(recs, over)], np.int32)
    planes = pad_planes(recs, ws, n, N)
    wmax = int((np.arange(N, dtype=np.int32) - planes[4]).max())
    W = min(-(-max(wmax, 1) // 32) * 32, N)
    return ChainPlan(planes, n, prm["mdx"], prm["mdy"], prm["bw"],
                     prm["nsegs"], avg32, cdd, cdel, over, W)


class _Params:
    """Per-record parameters on the device, as (B, 1) columns."""

    def __init__(self, plan: ChainPlan, dev: torch.device):
        def col(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None]
        self.mdx, self.mdy, self.bw = col(plan.mdx), col(plan.mdy), \
            col(plan.bw)
        self.multi = col(plan.nsegs > 1)
        self.avg32 = col(plan.avg32)
        self.corr_dd = col(plan.corr_dd)          # (B, 1, CORR_K)
        self.corr_delta = col(plan.corr_delta)
        # a float32 tensor, so that no double enters the product
        self.c001 = torch.tensor(0.01, dtype=f32, device=dev)


def _log2_floor(dd: torch.Tensor) -> torch.Tensor:
    """31 - clz(dd) for dd > 0, else 0: the exponent of dd as a float64,
    which holds every int32 exactly (a float32 rounds 2^k - 1 up to 2^k
    for k > 24)."""
    _, e = torch.frexp(dd.to(torch.float64))
    return torch.where(dd > 0, e - 1, 0)


def _linear_gap(dd: torch.Tensor, p: _Params) -> torch.Tensor:
    """(int)(dd * .01 * avg_qspan) in f64, the C's linear gap cost, for
    (B, K) dd: (f32)((f32)dd * 0.01f) * avg32, two separately rounded
    products (each its own kernel, so nothing fuses them into an FMA),
    truncated, plus the host's corrections where dd is a corrected value."""
    return ((dd.to(f32) * p.c001) * p.avg32).to(i32) + torch.where(
        dd[:, :, None] == p.corr_dd, p.corr_delta, 0).sum(2, dtype=i32)


def _anchor_step(ri, qi_i, span_i, sid_i, xs, qs, sids, scs, pks, pars,
                 inwin, base: int, p: _Params, jidx: torch.Tensor):
    """One anchor of every record against a (B, K) window of
    predecessors, window slot k being padded anchor index base + k.

    ri, qi_i, span_i, sid_i (B, 1): the anchor; xs, qs, sids, scs, pks
    (B, K): the window's x low words, qi, sid, scores and peaks; pars
    (B, K) int64: the padded index of each slot's parent, -1 for none;
    inwin (B, K): the slots inside the anchor's window (none for an
    inactive anchor).  Returns (score, peak, padded parent index or -1),
    each (B, 1)."""
    K = xs.shape[1]
    dr = ri - xs                    # int32 wraps: the C's u32 difference
    dq = qi_i - qs
    sid_eq = sid_i == sids
    dd = (dr - dq).abs()
    dr0 = dr == 0
    cont = (dq <= 0) | (dq > p.mdx) | (sid_eq & (
        dr0 | (dq > p.mdy) | (dd > p.bw) | (p.multi & (dr > p.mdy))))
    sc0 = torch.minimum(torch.minimum(dq, dr), span_i)
    c_lin = _linear_gap(dd, p)
    log_dd = _log2_floor(dd)
    gap = torch.where(sid_eq, c_lin + (log_dd >> 1),
                      torch.where(dr0, 0, torch.minimum(c_lin, log_dd)))
    sc = sc0 + (dr0 & ~sid_eq) - gap + scs

    eff = inwin & ~cont
    scv = torch.where(eff, sc, NEG)
    # running max when the descending scan reaches j: max(span, sc over
    # the eff j' > j), a reversed cumulative max shifted by one
    suff = scv.flip(1).cummax(1).values.flip(1)
    runmax = torch.maximum(span_i, F.pad(suff[:, 1:], (0, 1), value=NEG))
    better = eff & (sc > runmax)

    # t[j] == i: some eff j' (> j, as parents precede their anchors)
    # has parent j; slots whose parent lies below the window go to
    # the dummy column K
    rel = pars - base
    hit = torch.zeros((xs.shape[0], K + 1), dtype=torch.bool,
                      device=xs.device)
    hit.scatter_(1, torch.where(eff & (rel >= 0), rel, K), True)
    skip_hit = eff & ~better & hit[:, :K]
    c = skip_hit.to(i32) - better.to(i32)
    # n_skip when the scan reaches j, from 0 at the window's top: the
    # composition over j' > j of n -> max(n + c, 0), an exclusive
    # suffix scan of (C, M) maps n -> max(n + C, M), Hillis-Steele
    # doubling; the segment [j+d+1, j+2d] (C2, M2) runs before
    # [j+1, j+d] (C, M), so the pair composes to (C + C2,
    # max(M2 + C, M))
    C = F.pad(c[:, 1:], (0, 1))
    M = torch.zeros_like(C)
    d = 1
    while d < K:
        C2 = F.pad(C[:, d:], (0, d))
        M2 = F.pad(M[:, d:], (0, d))
        M = torch.maximum(M2 + C, M)
        C = C + C2
        d *= 2
    brk = skip_hit & (torch.maximum(C, M) >= MAX_SKIP)
    jstar = torch.where(brk, jidx, -1).amax(1, keepdim=True)
    valid = eff & (jidx > jstar)

    scv2 = torch.where(valid, sc, NEG)
    best = scv2.amax(1, keepdim=True)
    maxf = torch.maximum(span_i, best)
    # ties keep the largest j: the first one the descending scan meets
    jj = torch.where((scv2 == best) & (best > span_i), jidx, -1) \
        .amax(1, keepdim=True)
    pk_j = pks.gather(1, jj.clamp_min(0))
    pk = torch.where((jj >= 0) & (pk_j > maxf), pk_j, maxf)
    return maxf, pk, torch.where(jj >= 0, jj + base, -1)


def _chain_dp_win_device(planes: torch.Tensor, n: torch.Tensor, p: _Params,
                         W: int, steps: int):
    """Sliding-window chain DP: anchor i only scans j in [i-W, i), W >=
    every record's widest window (`plan_inputs`), so each step is a
    (B, W) op.  The anchor planes get W leading zero columns, so anchor
    i's window is always the slice [i, i+W) of the padded rows, and the
    window test becomes slot >= W - width(i).  Runs `steps` anchors
    (the plan's largest n).  Returns (scores, parents, peaks) (B, N)
    int32."""
    _, B, N = planes.shape
    dev = planes.device
    iota = torch.arange(N, dtype=i32, device=dev)
    act = iota < n[:, None]
    # first in-window slot of each anchor; W (no slot) past a row's n
    thr = torch.where(act, W - (iota - planes[4]), W)
    IN = F.pad(torch.cat([planes[:4], thr[None]]), (W, 0))  # (5, B, N+W)
    X, Q, SPAN, SID, THR = IN
    SP = torch.zeros((2, B, N + W), dtype=i32, device=dev)  # scores, peaks
    PP = torch.full((B, N + W), -1, dtype=i64, device=dev)  # padded parent
    jidx = torch.arange(W, dtype=i64, device=dev)
    with span("chain.loop"):
        for i in range(steps):
            a, w = W + i, slice(i, i + W)
            maxf, pk, pidx = _anchor_step(
                X[:, a, None], Q[:, a, None], SPAN[:, a, None],
                SID[:, a, None], X[:, w], Q[:, w], SID[:, w], SP[0, :, w],
                SP[1, :, w], PP[:, w], jidx >= THR[:, a, None], i, p, jidx)
            SP[0, :, a] = maxf[:, 0]
            SP[1, :, a] = pk[:, 0]
            PP[:, a] = pidx[:, 0]
    parents = torch.where(PP >= 0, PP - W, -1).to(i32)
    return SP[0, :, W:], parents[:, W:], SP[1, :, W:]


def run_plan(plan: ChainPlan, dev: torch.device,
             lap: Optional[Laps] = None) -> np.ndarray:
    """Copy one plan to `dev`, run the kernel and return (3, B, N) int32
    scores, parents, peaks, in the spans `chain.h2d`, `chain.dp`,
    `chain.wait` (the card's queue drained, on CUDA) and `chain.d2h`;
    `lap` marks them as h2d_s, loop_s, loop_s and d2h_s."""
    with span("chain.h2d", lap, "h2d_s"):
        planes = torch.from_numpy(plan.planes).to(dev)
        n = torch.from_numpy(plan.n).to(dev)
        p = _Params(plan, dev)
    with span("chain.dp", lap, "loop_s"):
        out = _chain_dp_win_device(planes, n, p, plan.W, int(plan.n.max()))
    with span("chain.wait", lap, "loop_s"):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    with span("chain.d2h", lap, "d2h_s"):
        return torch.stack(out).cpu().numpy()


def scalar_dp(recs: Sequence[chain_io.ChainRecord],
              ws: Sequence[np.ndarray]) -> List[tuple]:
    """The exact scalar DP in C (native/chain.c::chain_dp_scalar) over
    `recs` with window starts `ws`: [(scores, parents, peaks)]."""
    ns = np.array([r.n for r in recs], np.int64)
    x_lo, qi, span, sid = _flat_decode([r.x for r in recs],
                                       [r.y for r in recs])
    flat = native.chain_dp_scalar(
        ns, [np.float32(r.avg_qspan) for r in recs],
        [r.max_dist_x for r in recs], [r.max_dist_y for r in recs],
        [r.bw for r in recs], [r.n_segs for r in recs], x_lo, qi, span,
        sid, np.concatenate(list(ws) + [np.zeros(0, np.int32)]))
    offs = np.concatenate([[0], np.cumsum(ns)])
    return [tuple(a[offs[b]:offs[b + 1]] for a in flat)
            for b in range(len(recs))]


def chain_batch(records: Sequence[chain_io.ChainRecord],
                device: Optional[str] = None,
                stats: Optional[Dict[str, float]] = None,
                mesh: Optional[Mesh] = None) -> List[tuple]:
    """chain_dp over records: [(scores, parents, peaks)] in order.

    Records go into plans of at most MAX_BATCH records and CELL_BUDGET
    padded cells, each run by the windowed kernel; the records
    `gap_corrections` defers run the scalar C DP.  With a mesh, each
    plan's records split over its devices (`shard_items`), one plan of
    its own on each.

    The call is the span `chain.batch`, tiled by `chain.starts` (window
    starts), `chain.plan` (the plans, then each plan's inputs),
    `run_plan`'s spans, `chain.unpack` (each plan's results) and
    `chain.scalar` (the deferred records), closed by the counts
    `chain.records`, `.plans` and `.deferred`.  `stats`, when a dict,
    is filled with the plans, their (W, N) window widths and padded
    lengths, the anchor steps and deferred records of the run and the
    seconds of host preparation, copies, anchor loops and scalar DP:
    the spans' own, the first device synchronized at each span's end."""
    with span("chain.batch"):
        devs = mesh_devices(mesh, device)
        counts = dict(plans=0, widths=[], steps=0)
        if stats is not None:
            stats.update(prep_s=0.0, h2d_s=0.0, loop_s=0.0, d2h_s=0.0,
                         scalar_s=0.0)
        lap = Laps(stats, devs[0])
        results: List[tuple] = [None] * len(records)
        with span("chain.starts", lap, "prep_s"):
            ws_all = chain_io.window_starts_all(records, MAX_ITER)
        with span("chain.plan", lap, "prep_s"):
            parts = [(plan.length, dev, part) for plan in plan_batches(
                [r.n for r in records], CELL_BUDGET, MAX_BATCH)
                for dev, part in zip(devs, shard_items(
                    np.asarray(plan.indices), mesh))]
        deferred: Dict[int, None] = {}     # ordered, once each
        for length, dev, part in parts:
            with span("chain.plan", lap, "prep_s"):
                host = plan_inputs([records[k] for k in part],
                                   [ws_all[k] for k in part], length)
                deferred.update((int(part[b]), None)
                                for b in np.flatnonzero(host.over))
                counts["plans"] += 1
                counts["widths"].append((host.W, length))
                counts["steps"] += int(host.n.max())
            with device_scope(dev):
                out = run_plan(host, dev, lap)
            with span("chain.unpack", lap, "prep_s"):
                for b, k in enumerate(part):
                    if not host.over[b]:
                        results[k] = tuple(out[:, b, :records[k].n])
        with span("chain.scalar", lap, "scalar_s"):
            deferred = list(deferred)
            sub = scalar_dp([records[k] for k in deferred],
                            [ws_all[k] for k in deferred])
            for k, res in zip(deferred, sub):
                results[k] = res
        counts["deferred"] = len(deferred)
        for name, n in (("records", len(records)),
                        ("plans", counts["plans"]),
                        ("deferred", counts["deferred"])):
            count(f"chain.{name}", n)
    if stats is not None:
        stats.update(counts)
    return results


def run(argv: Sequence[str]) -> int:
    """CLI byte-compatible with the reference chain binary
    (chain/src/main.cpp:60-207): -i input -o output [-t ignored]."""
    import argparse
    p = argparse.ArgumentParser(prog="chain")
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("-t", dest="threads", type=int, default=1)
    args = p.parse_args(argv)

    dev = resolve_device()
    records = chain_io.read_records_path(args.input)
    roi = ROITimer("chain", "Time in kernel: {t:.2f} sec")
    with roi:
        results = chain_batch(records, device=dev, mesh=data_mesh())
    roi.report()

    with open(args.output, "w") as f:
        chain_io.write_returns(f, [(s, p_) for s, p_, _ in results])
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
