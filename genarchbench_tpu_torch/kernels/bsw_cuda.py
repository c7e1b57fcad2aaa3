"""Banded affine-gap Smith-Waterman: the wrapper of the CUDA kernel
(csrc/bsw.cu) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
(genarchbench_tpu/kernels/bsw_pallas.py::_kernel); the plain version is
a port of the row step it runs (kernels/bsw.py::_row_factory) and of
the XLA row loop around it (kernels/bsw.py::_bsw_device).

Inputs, one group of L pairs per leading index (L = 8, or 16 for -i8):
  seq1 (G, L, R)  uint8  reference codes: bases 0-3, 13 padding, 15 ambiguous
  seq2 (G, L, C2) uint8  query codes: bases 0-3, 14 padding, 15 ambiguous
  len1, len2, h0, myband (G, L) int32
Rows past R are not run, and columns past C2 do not exist (callers
size R to the longest reference and C2 past the longest query).  Six
(G, L) int32 tensors come back: score, tle, qle, max_off, gscore, gtle.

The kernel runs one block per group, one warp per pair, the blocks
taking the groups longest first (`group_order`).  Rows of up to
32 * MAX_ROW_K columns live in registers, K = ceil(C2 / 32) columns a
thread; wider rows take a variant that keeps them in shared memory
(`kernel_variant`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from genarchbench_tpu_torch.kernels import _build

NEG = -(1 << 28)
BIG = 1 << 28
AMBIG_SENTINEL = 15

MAX_ROW_K = 8        # the register kernel's columns a thread (C2 <= 256)

# launches of the CUDA kernel in this process (a run shows with it that
# the main path went through the kernel)
LAUNCHES = 0


def _lib():
    lib = _build.library()
    fn = lib.genarch_bsw
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 15 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def wide_smem_bytes(L: int, C2: int) -> int:
    """Dynamic shared memory of the wide-row kernel: the group's H and F
    rows, each pair's nonzero-column masks and three per-pair slots."""
    return 4 * (2 * L * C2 + L * ((C2 + 31) // 32 + 1) + 3 * L)


def kernel_variant(L: int, C2: int, smem_limit: int) -> Tuple[int, int]:
    """(K, 0) for the register kernel with K columns a thread, or (0,
    shared bytes) for the wide-row kernel, chosen by C2; raises where
    neither fits a block of L warps."""
    if not 1 <= L <= 32:
        raise ValueError(f"a block of {L} warps: L must be 1..32 "
                         "(1024 threads at most)")
    K = max(1, (C2 + 31) // 32)
    if K <= MAX_ROW_K:
        return K, 0
    smem = wide_smem_bytes(L, C2)
    if smem > smem_limit:
        raise ValueError(
            f"bsw kernel: {L} pairs x {C2} columns need {smem} B of shared "
            f"memory for the H and F rows, more than the {smem_limit} B a "
            "block may have on this card")
    return 0, smem


def group_order(len1: torch.Tensor, R: int) -> torch.Tensor:
    """(G,) int32: the groups by descending row count (the longest
    reference in the group, at most R), ties in group order; block b of
    the kernel runs group order[b]."""
    rows = len1.amax(dim=1).clamp_max(R)
    return torch.argsort(rows, descending=True, stable=True).to(torch.int32)


def _check(seq1, seq2, lane_args):
    if seq1.dim() != 3 or seq2.dim() != 3 or seq1.shape[:2] != seq2.shape[:2]:
        raise ValueError(f"seq1 (G, L, R) and seq2 (G, L, C2) disagree: "
                         f"{tuple(seq1.shape)} vs {tuple(seq2.shape)}")
    G, L = seq2.shape[:2]
    for name, x, dt, shape in (("seq1", seq1, torch.uint8, None),
                               ("seq2", seq2, torch.uint8, None),
                               *((n, a, torch.int32, (G, L))
                                 for n, a in lane_args.items())):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != seq2.device:
            raise ValueError(f"{name} is on {x.device}, seq2 on {seq2.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bsw_scores(seq1, seq2, len1, len2, h0, myband, *, match: int,
               mismatch: int, ambig: int, o_del: int, e_del: int,
               o_ins: int, e_ins: int, zdrop: int, w: int
               ) -> Tuple[torch.Tensor, ...]:
    """Launches the CUDA kernel for CUDA tensors and runs
    `bsw_scores_plain` for CPU tensors.  `mismatch` and `ambig` are the
    signed scores (fill_scmat)."""
    global LAUNCHES
    lane_args = dict(len1=len1, len2=len2, h0=h0, myband=myband)
    _check(seq1, seq2, lane_args)
    sc = dict(match=match, mismatch=mismatch, ambig=ambig, o_del=o_del,
              e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w=w)
    if seq2.device.type == "cpu":
        return bsw_scores_plain(seq1, seq2, len1, len2, h0, myband, **sc)
    if seq2.device.type != "cuda":
        raise ValueError(f"bsw_scores runs on cuda or cpu, not {seq2.device}")
    G, L, C2 = seq2.shape
    R = seq1.shape[2]
    K, smem = kernel_variant(L, C2, torch.cuda.get_device_properties(
        seq2.device).shared_memory_per_block_optin)
    out = torch.empty((6, G, L), dtype=torch.int32, device=seq2.device)
    if G == 0:
        return tuple(out)
    order = group_order(len1, R)
    lib = _lib()
    stream = torch.cuda.current_stream(seq2.device).cuda_stream
    err = lib.genarch_bsw(seq1.data_ptr(), seq2.data_ptr(), len1.data_ptr(),
                          len2.data_ptr(), h0.data_ptr(), myband.data_ptr(),
                          order.data_ptr(), out.data_ptr(), G, L, R, C2, K,
                          smem,
                          *(sc[k] for k in ("match", "mismatch", "ambig",
                                            "o_del", "e_del", "o_ins",
                                            "e_ins", "zdrop", "w")),
                          stream)
    LAUNCHES += 1
    _build.check(err, "bsw kernel")
    return tuple(out)


def bsw_scores_plain(seq1, seq2, len1, len2, h0, myband, *, match: int,
                     mismatch: int, ambig: int, o_del: int, e_del: int,
                     o_ins: int, e_ins: int, zdrop: int, w: int,
                     return_cells: bool = False):
    """The same six outputs with torch ops, one DP row of every group
    per step (bsw.py:103-331).  With `return_cells`, also returns the
    number of banded DP cells the rows evaluated (the [beg, end) columns
    of every active group's rows, times L)."""
    G, L, C2 = seq2.shape
    R = seq1.shape[2]
    dev = seq2.device
    i32 = torch.int32
    oe_ins = o_ins + e_ins
    oe_del = o_del + e_del

    def lane(x):
        return x.to(i32).view(G, L, 1)

    len1, qlen, h0, myband = lane(len1), lane(len2), lane(h0), lane(myband)
    s1all = seq1.to(i32)
    s2 = seq2.to(i32)
    cols = torch.arange(C2, dtype=i32, device=dev).view(1, 1, C2)
    nrow = len1.amax(dim=1, keepdim=True)                     # (G,1,1)
    ncol = qlen.amax(dim=1, keepdim=True)
    mlen = torch.minimum(qlen + myband, len1)

    # H row-0 boundary (wrapper :3680-3694)
    H = torch.where(cols == 0, h0,
                    torch.clamp_min(h0 - oe_ins - (cols - 1) * e_ins, 0))
    H = torch.where(cols < ncol, H, 0)
    F = torch.zeros((G, L, C2), dtype=i32, device=dev)

    zeros_l = torch.zeros((G, L, 1), dtype=i32, device=dev)
    head, tail = zeros_l, qlen
    exit0 = torch.ones((G, L, 1), dtype=torch.bool, device=dev)
    max_score, x, y, max_off = h0, zeros_l, zeros_l, zeros_l
    gscore = torch.full((G, L, 1), -1, dtype=i32, device=dev)
    max_ie = zeros_l
    nbeg = torch.zeros((G, 1, 1), dtype=i32, device=dev)
    nend = ncol
    alive = torch.ones((G, 1, 1), dtype=torch.bool, device=dev)
    neg_col = torch.full((G, L, 1), NEG, dtype=i32, device=dev)
    cells = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(R):
        act = alive & (i < nrow)                               # (G,1,1)
        # group-shared banding (kernel :3846-3852)
        beg = torch.clamp_min(nbeg, i - w)
        end = torch.minimum(torch.clamp_max(nend, i + w + 1), ncol)
        if return_cells:
            cells += ((end - beg).clamp_min(0) * act).sum() * L

        # per-lane adaptive band head/tail (kernel :3866-3876)
        phead, ptail = head, tail
        head = torch.where(act, torch.clamp_min(head, i - myband), head)
        tail = torch.where(act, torch.minimum(
            torch.minimum(tail, i + 1 + myband), qlen), tail)

        # band-trim zeroing (kernel :3878-3902)
        changed = ((head != phead) | (tail != ptail)).any(dim=1, keepdim=True)
        maxhead = head.amax(dim=1, keepdim=True)
        zcond = ((cols >= beg) & (cols < torch.minimum(end, maxhead))
                 & ((head > cols) | (cols + 1 > tail)) & changed & act)
        H = torch.where(zcond, 0, H)
        F = torch.where(zcond, 0, F)

        # per-lane exit conditions (kernel :3906-3915)
        dead = (i + 1 > mlen) | (tail == head) | (head > tail)
        exit0 = exit0 & ~(act & dead)

        # whole-row DP (kernel :3921-3993)
        s1 = s1all[:, :, i:i + 1]
        sbt = torch.full_like(s2, mismatch).masked_fill_(s1 == s2, match)
        sbt.masked_fill_(torch.maximum(s1, s2) == AMBIG_SENTINEL, ambig)
        m11 = torch.where(H == 0, 0, H + sbt)
        jmask = (cols >= beg) & (cols < end)
        # E chain: e' = max(max(m - oe_ins, 0), e - e_ins), e(beg) = 0
        a = torch.clamp_min(m11 - oe_ins, 0)
        b = torch.where(jmask, a + cols * e_ins, NEG)
        s_inc = torch.cummax(b, dim=2).values
        s_exc = torch.cat([neg_col, s_inc[:, :, :-1]], dim=2)
        e11 = torch.where(cols == beg, 0, s_exc - (cols - 1) * e_ins)
        e11 = torch.clamp_min(e11, NEG // 2)
        f11 = F
        h11 = torch.maximum(torch.maximum(m11, e11), f11)
        f21 = torch.maximum(torch.clamp_min(m11 - oe_del, 0), f11 - e_del)

        # masked stores: H[j] = h11[j-1] (h10 at beg), F[j] = f21, zeroed
        # outside [head, tail]
        h10 = torch.where(beg == 0,
                          torch.clamp_min(h0 - o_del - (i + 1) * e_del, 0), 0)
        sh = torch.cat([zeros_l, h11[:, :, :-1]], dim=2)
        sh = torch.where(cols == beg, h10, sh)
        zstore = (head > cols) | (cols > tail)
        wmask = jmask & act
        H = torch.where(wmask, torch.where(zstore, 0, sh), H)
        F = torch.where(wmask, torch.where(zstore, 0, f21), F)
        # trailing store at j=end (kernel :3994-3995)
        idx_end = torch.clamp_min(end - 1, 0)
        h_endval = torch.where(cols == idx_end, h11, NEG).amax(dim=2,
                                                              keepdim=True)
        h_endval = torch.where(end > beg, h_endval, h10)
        endmask = (cols == end) & act
        H = torch.where(endmask, h_endval, H)
        F = torch.where(endmask, 0, F)

        # row max + its (last) column, restricted to j < tail (:3958-3969)
        mmask = jmask & (cols < tail)
        max_rs = torch.clamp_min(
            torch.where(mmask, h11, NEG).amax(dim=2, keepdim=True), 0)
        qual = mmask & (h11 == max_rs)
        y1 = torch.where(qual, cols + 1, 0).amax(dim=2, keepdim=True)

        # gscore at each lane's last query column (kernel :3975-3993)
        qidx = torch.clamp_min(qlen - 1, 0)
        h11q = torch.where(cols == qidx, h11, NEG).amax(dim=2, keepdim=True)
        gupd = (act & (qlen - 1 >= beg) & (qlen - 1 < end) & exit0
                & (qlen <= tail))
        max_ie = torch.where(gupd & ~(gscore > h11q), i + 1, max_ie)
        gscore = torch.where(gupd, torch.maximum(gscore, h11q), gscore)

        # whole-group zero row => break before the post-row updates
        # (kernel :3999-4003)
        allzero = (max_rs == 0).all(dim=1, keepdim=True) & act
        alive = alive & ~allzero
        post = act & ~allzero

        exit0 = exit0 & ~(post & (max_rs == 0))
        bmax = max_score
        max_score = torch.where(post & exit0, torch.maximum(bmax, max_rs),
                                bmax)
        inc = post & (max_score > bmax)
        x = torch.where(inc, i + 1, x)
        y = torch.where(inc, y1, y)
        off = (y1 - (i + 1)).abs()
        max_off = torch.where(inc, torch.maximum(max_off, off), max_off)
        # z-drop, vector variant (ZSCORE16 :3380-3394)
        zd = (max_score - max_rs) - ((i + 1 - x) - (y1 - y)).abs()
        exit0 = exit0 & ~(post & (zd > zdrop))

        # band narrowing from the zero structure of F|H
        fh0 = (F == 0) & (H == 0)
        allz = fh0.all(dim=1, keepdim=True)                    # (G,1,C2)
        rng = (cols >= beg) & (cols < end)
        first_not = torch.where(rng & ~allz, cols, BIG).amin(dim=2,
                                                             keepdim=True)
        c_lead = torch.minimum(first_not, end) - beg
        nbeg = torch.where(post & (c_lead >= 1), beg + c_lead - 1, nbeg)
        rng2 = (cols >= beg) & (cols <= end)
        l_stop = torch.where(rng2 & ~allz, cols, -1).amax(dim=2, keepdim=True)
        l_stop = torch.maximum(l_stop, beg - 1)
        nend = torch.where(post, torch.minimum(l_stop + 2, ncol), nend)
        # head: per-lane leading zero-run among active lanes (:4044-4070)
        zeroact = fh0 & exit0
        fnl = torch.where(rng & ~zeroact, cols, BIG).amin(dim=2, keepdim=True)
        run = torch.minimum(fnl, end) - beg
        head = torch.where(post & (run >= 1), beg + run, head)
        # tail: per-lane trailing zero-run over [beg, end] (:4074-4110)
        lnq = torch.where(rng2 & ~zeroact, cols, -1).amax(dim=2, keepdim=True)
        lnq = torch.maximum(lnq, beg - 1)
        index = torch.where(end - lnq >= 1, lnq, tail)
        tail = torch.where(post, torch.minimum(index + 2, qlen), tail)

    outs = tuple(v[:, :, 0].to(i32).contiguous()
                 for v in (max_score, x, y, max_off, gscore, max_ie))
    return (outs, int(cells)) if return_cells else outs
