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
from typing import Callable, Dict, List, Optional, Sequence

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
    """The concatenated u64 anchor arrays as flat planes: x_lo (uint32),
    qi (int32), span (uint8, y bits 32-39) and sid (uint8, y bits
    48-55)."""
    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    lo, b8 = np.uint64(0xFFFFFFFF), np.uint64(0xFF)
    return ((x & lo).astype(np.uint32),
            (y & lo).astype(np.uint32).view(np.int32),
            ((y >> np.uint64(32)) & b8).astype(np.uint8),
            ((y >> np.uint64(48)) & b8).astype(np.uint8))


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


def pad_planes(flat: chain_io.FlatRecords, idx: np.ndarray, n: np.ndarray,
               N: int) -> np.ndarray:
    """(5, B, N) int32 planes of the first n[b] anchors of record idx[b]
    of `flat`: x's low word (uint32 bits), qi, span, sid and the window
    start st, which is i past n[b] (an empty window); zeros elsewhere.
    Each row is decoded from its record's flat offset in C
    (native/chain.c::chain_gather_planes); `pad_planes_plain` builds the
    same planes record by record."""
    return native.chain_gather_planes(flat.x, flat.y, flat.st,
                                      flat.offs[idx], n, N)


def pad_planes_plain(recs: Sequence[chain_io.ChainRecord],
                     ws: Sequence[np.ndarray], n: np.ndarray,
                     N: int) -> np.ndarray:
    """`pad_planes` record by record, from each record's own x, y and
    window starts `ws`."""
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


def run_plans(kind: str, records, device, stats, mesh, *, max_batch: int,
              cell_budget: int, seconds, counts: dict, emit, prepare,
              upload, dp, dp_key: Optional[str], wait_key: str,
              finish: Optional[Callable] = None) -> List[tuple]:
    """The frame of both chaining entries, `chain_batch` and
    `fast_chain.fast_chain_batch`: [(scores, parents, peaks or None)] of
    every record in order.

    The records are laid end to end once (`chain_io.FlatRecords`) and
    cut into plans of at most max_batch records and cell_budget padded
    cells, each split over the mesh's devices (`shard_items`).  A plan's
    records idx at padded length N run as `prepare(flat, idx, N)`, which
    returns its host inputs and the rows' lengths (in `<kind>.plan`),
    `upload(host, dev)` (`.h2d`), `dp(host, inputs, lap)` (`.dp`), the
    card's queue drained (`.wait`), the DP's outputs stacked to the host
    (`.d2h`) and row b's first n[b] made record idx[b]'s result
    (`.unpack`); then `finish(flat, lap, results)`.  The counts
    `<kind>.<name>` of `emit` close the root span `<kind>.batch`.
    `stats`, when a dict, gets `seconds`, summed from the spans (prep_s,
    h2d_s, d2h_s, `dp_key` unless None, `wait_key`), then `counts`."""
    with span(f"{kind}.batch"):
        devs = mesh_devices(mesh, device)
        if stats is not None:
            stats.update(dict.fromkeys(seconds, 0.0))
        lap = Laps(stats, devs[0])
        results: List[tuple] = [None] * len(records)
        with span(f"{kind}.starts", lap, "prep_s"):
            flat = chain_io.FlatRecords.of(records, MAX_ITER)
        with span(f"{kind}.plan", lap, "prep_s"):
            parts = [(plan.length, dev, part) for plan in plan_batches(
                flat.n, cell_budget, max_batch)
                for dev, part in zip(devs, shard_items(
                    np.asarray(plan.indices), mesh))]
        for length, dev, part in parts:
            with span(f"{kind}.plan", lap, "prep_s"):
                host, n = prepare(flat, part, length)
            with device_scope(dev):
                with span(f"{kind}.h2d", lap, "h2d_s"):
                    inputs = upload(host, dev)
                with span(f"{kind}.dp", lap if dp_key else None, dp_key):
                    out = dp(host, inputs, lap)
                with span(f"{kind}.wait", lap, wait_key):
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
                with span(f"{kind}.d2h", lap, "d2h_s"):
                    out = torch.stack(out).cpu().numpy()
            with span(f"{kind}.unpack", lap, "prep_s"):
                # slices of the flat rows by plain ints, one tuple a
                # record: a generator a record costs 5x as much
                sc, pa, *pk = out.reshape(len(out), -1)
                for k, a, e in zip(part.tolist(), range(0, sc.size, length),
                                   (np.arange(0, sc.size, length)
                                    + n).tolist()):
                    results[k] = (sc[a:e], pa[a:e],
                                  pk[0][a:e] if pk else None)
            # this plan's planes and device inputs go before the next
            # plan's are made
            del host, inputs
        if finish is not None:
            finish(flat, lap, results)
        for name in emit:
            count(f"{kind}.{name}",
                  len(records) if name == "records" else counts[name])
    if stats is not None:
        stats.update(counts)
    return results


def plan_inputs(flat: chain_io.FlatRecords, idx: np.ndarray,
                N: int) -> ChainPlan:
    """The padded (B, N) inputs of one plan, records idx of `flat`, their
    gap corrections and window width: the widest window rounded up to
    32, or N when that is narrower."""
    mdx, mdy, bw, nsegs = (a[idx].astype(np.int32) for a in (
        flat.max_dist_x, flat.max_dist_y, flat.bw, flat.n_segs))
    avg32 = flat.avg_qspan[idx]
    t_size = int(max(flat.max_dist_x[idx].max(), flat.bw[idx].max())) + 1
    cdd, cdel, over = gap_corrections(avg32, t_size)
    n = np.where(over, 0, flat.n[idx]).astype(np.int32)
    planes = pad_planes(flat, idx, n, N)
    wmax = int((np.arange(N, dtype=np.int32) - planes[4]).max())
    W = min(-(-max(wmax, 1) // 32) * 32, N)
    return ChainPlan(planes, n, mdx, mdy, bw, nsegs, avg32, cdd, cdel, over,
                     W)


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


def upload_plan(plan: ChainPlan, dev: torch.device):
    """One plan's planes, lengths and (B, 1) parameters on `dev`."""
    return (torch.from_numpy(plan.planes).to(dev),
            torch.from_numpy(plan.n).to(dev), _Params(plan, dev))


def window_dp(plan: ChainPlan, inputs, lap: Optional[Laps] = None):
    """The windowed kernel on one plan's `upload_plan` inputs."""
    return _chain_dp_win_device(*inputs, plan.W, int(plan.n.max()))


def scalar_dp(flat: chain_io.FlatRecords, idx: np.ndarray) -> List[tuple]:
    """The exact scalar DP in C (native/chain.c::chain_dp_scalar) over the
    records idx of `flat`, each read at its flat offset:
    [(scores, parents, peaks)] in idx's order."""
    idx = np.asarray(idx, np.int64)
    ns = flat.n[idx]
    out = native.chain_dp_scalar(
        flat.x, flat.y, flat.st, flat.offs[idx], ns, flat.avg_qspan[idx],
        *(a[idx] for a in (flat.max_dist_x, flat.max_dist_y, flat.bw,
                           flat.n_segs)))
    o = np.concatenate([[0], np.cumsum(ns)]).tolist()
    return [tuple(a[s:e] for a in out) for s, e in zip(o[:-1], o[1:])]


def chain_batch(records: Sequence[chain_io.ChainRecord],
                device: Optional[str] = None,
                stats: Optional[Dict[str, float]] = None,
                mesh: Optional[Mesh] = None) -> List[tuple]:
    """chain_dp over records: [(scores, parents, peaks)] in order.

    `run_plans` runs the plans by the windowed kernel (its anchor loop
    the span `chain.loop`); then the records `gap_corrections` defers
    run the scalar C DP once each, in the span `chain.scalar`.  `stats`
    gets the plans, their (W, N), the anchor steps, the deferred records
    and the seconds of host preparation, copies, anchor loops (`.dp`,
    `.wait`) and scalar DP."""
    counts = dict(plans=0, widths=[], steps=0, deferred=0)
    deferred: Dict[int, None] = {}     # ordered, once each

    def prepare(flat, idx, N):
        plan = plan_inputs(flat, idx, N)
        deferred.update((k, None) for k in idx[plan.over].tolist())
        counts["plans"] += 1
        counts["widths"].append((plan.W, N))
        counts["steps"] += int(plan.n.max())
        return plan, plan.n

    def finish(flat, lap, results):
        with span("chain.scalar", lap, "scalar_s"):
            idx = np.fromiter(deferred, np.int64, len(deferred))
            for k, res in zip(idx.tolist(), scalar_dp(flat, idx)):
                results[k] = res
        counts["deferred"] = len(deferred)

    return run_plans(
        "chain", records, device, stats, mesh, max_batch=MAX_BATCH,
        cell_budget=CELL_BUDGET,
        seconds=("prep_s", "h2d_s", "loop_s", "d2h_s", "scalar_s"),
        counts=counts, emit=("records", "plans", "deferred"), prepare=prepare,
        upload=upload_plan, dp=window_dp, dp_key="loop_s", wait_key="loop_s",
        finish=finish)


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
