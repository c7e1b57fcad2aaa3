"""Striped Smith-Waterman (SSW), the Clair3 realigner's aligner, as torch
ops.

Reference semantics: nn-variant/Clair3/preprocess/realign/ssw.c —
`ssw_align` (:762-855): a forward pass finds (score1, ref_end1,
read_end1) plus the masked second-best column (:300-325); a reverse
pass over the reversed prefixes, terminated at score1, yields
(ref_begin1, read_begin1) (:820-833); `banded_sw` (:532-717) then
produces the cigar over the bounded window.  The realigner drives it
with match=4, mismatch=6, gapO=8, gapE=2 (realigner.cpp:64-73) and
maskLen = read length.

The design is the JAX package's (nn/ssw.py), which has no Pallas
kernel: both column sweeps run batched over the pairs on the device,
one reference column a step with every read row at once.  SSW's lazy-F
loop never reopens a gap from an F-dominated cell (ssw.c:228), so
    F[j] = max_{j'<j} (Hpre[j'] - gapO - (j-1-j') * gapE)
is one running maximum of Hpre[j'] + j'*gapE (`torch.cummax`), and E
opens from Hpre only.  The banded cigar DP and its traceback run on the
host, in Python, as in JAX.  All of it is int32.

What differs from JAX: the sweep runs in blocks of BLOCK steps
(`core/blocks.py`).  A step reads its column at an index held in a
device tensor and writes the column maximum through a device-held slot
(a spare column takes the padding steps' writes), so on the card one
block is captured as a CUDA graph and replayed; on the CPU, and on the
card with graphed=False, the same blocks run eagerly.  The sweep stops
after the block in which every pair has stopped (reached `terminate`)
or passed its reference: JAX runs all Lref steps, but the steps after
that change no output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.blocks import run_blocks

BLOCK = 32

_ENC = np.full(256, 4, np.int8)
for _i, _c in enumerate("ACGT"):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i


def default_matrix(match: int, mismatch: int) -> np.ndarray:
    """ssw_cpp BuildDefaultMatrix: (5,5) with N rows/cols scoring 0."""
    m = np.full((5, 5), -mismatch, np.int32)
    np.fill_diagonal(m, match)
    m[4, :] = 0
    m[:, 4] = 0
    return m


@dataclasses.dataclass
class SswAlignment:
    score1: int
    score2: int
    ref_begin1: int
    ref_end1: int
    read_begin1: int
    read_end1: int
    ref_end2: int
    cigar: List[Tuple[int, str]]        # [(length, op)] ops M/I/D

    def cigar_string(self) -> str:
        return "".join(f"{n}{op}" for n, op in self.cigar)


class _SweepState:
    """The sweep's carry, updated in place by `_sweep_step`; maxcol has a
    spare column Lref for the writes of steps past the reference."""

    def __init__(self, refs, reads, ref_len, read_len, mat, terminate,
                 Lref, Lread, gapO, gapE, reverse):
        B = refs.shape[0]
        dev = refs.device
        i32 = torch.int32
        self.Lref, self.gapO, self.gapE, self.reverse = (Lref, gapO, gapE,
                                                         reverse)
        self.refs = refs.long()
        self.ref_len = ref_len.int()
        self.terminate = terminate.int()
        self.term_on = self.terminate > 0
        # the query profile: prof[b, c, j] = mat[c, reads[b, j]]
        self.prof = mat.to(dev, i32)[:, reads.long()].permute(1, 0, 2) \
            .contiguous()
        self.jidx = torch.arange(Lread, dtype=i32, device=dev)[None, :]
        self.valid = self.jidx < read_len.int()[:, None]
        self.gj = gapE * self.jidx
        self.fo = gapO + gapE * (self.jidx - 1)
        self.zcol = torch.zeros((B, 1), dtype=i32, device=dev)
        self.neg = torch.full((B, 1), -(1 << 30), dtype=i32, device=dev)
        z = torch.zeros((B, Lread), dtype=i32, device=dev)
        self.Hprev, self.E, self.Hbest = z, z.clone(), z.clone()
        self.best = torch.zeros(B, dtype=i32, device=dev)
        self.best_i = torch.full((B,), -1, dtype=i32, device=dev)
        self.maxcol = torch.zeros((B, Lref + 1), dtype=i32, device=dev)
        self.stop = torch.zeros(B, dtype=torch.bool, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)   # step


def _sweep_step(s: _SweepState) -> None:
    """One reference column for every pair (JAX ssw.py:77-112)."""
    Lref = s.Lref
    col = (Lref - 1 - s.i) if s.reverse else s.i
    if s.reverse:
        live = ~s.stop & (col >= Lref - s.ref_len)
    else:
        live = ~s.stop & (col < s.ref_len)
    inb = (col >= 0) & (col < Lref)
    rb = s.refs.index_select(1, col.clamp(0, Lref - 1).view(1))   # (B, 1)
    sc = s.prof.gather(1, rb[:, :, None].expand(-1, 1, s.prof.shape[2]))
    diag = torch.cat([s.zcol, s.Hprev[:, :-1]], 1)
    Hpre = torch.maximum(diag + sc[:, 0], s.E).clamp_min(0)
    Hpre = torch.where(s.valid, Hpre, 0)
    cm = torch.cummax(Hpre + s.gj, 1).values
    F = (torch.cat([s.neg, cm[:, :-1]], 1) - s.fo).clamp_min(0)
    H = torch.where(s.valid, torch.maximum(Hpre, F), 0)
    En = torch.maximum(s.E - s.gapE, Hpre - s.gapO).clamp_min(0)

    cmax = H.amax(1)
    upd = live & (cmax > s.best)                  # strict: first column
    s.best.copy_(torch.where(upd, cmax, s.best))
    s.best_i.copy_(torch.where(upd, col.int(), s.best_i))
    s.Hbest.copy_(torch.where(upd[:, None], H, s.Hbest))
    slot = torch.where(inb, col, Lref).view(1)
    old = s.maxcol.index_select(1, slot)[:, 0]
    s.maxcol.index_copy_(1, slot, torch.where(live, cmax, old)[:, None])
    s.stop.logical_or_(live & s.term_on & (cmax == s.terminate))
    s.Hprev.copy_(torch.where(live[:, None], H, s.Hprev))
    s.E.copy_(torch.where(live[:, None], En, s.E))
    s.i.add_(1)


def _sweep(refs, reads, ref_len, read_len, mat, terminate, Lref, Lread,
           gapO, gapE, reverse, block: int = BLOCK,
           graphed: Optional[bool] = None, counts: Optional[dict] = None):
    """Batched SSW column sweep (sw_sse2_* math, exact max/tie rules) on
    the tensors' device: refs (B, Lref) and reads (B, Lread) base codes
    0-4, ref_len, read_len and terminate (B,), mat (5, 5).
    reverse=True iterates ref columns high->low; a pair stops once a
    column max reaches its `terminate` (> 0).  Returns (best score,
    best ref col, best read row, maxColumn (B, Lref)), all int32.
    graphed (default: on the card) replays each block as a CUDA graph;
    `counts` gets the steps and blocks run."""
    if graphed is None:
        graphed = refs.is_cuda
    s = _SweepState(refs, reads, ref_len, read_len, mat, terminate, Lref,
                    Lread, gapO, gapE, reverse)

    def run_block():
        for _ in range(block):
            _sweep_step(s)

    # a pair is live only at steps i < ref_len, in both directions
    steps = min(int(ref_len.max()) if len(ref_len) else 0, Lref)
    ran = 0
    if steps:
        ran = run_blocks(run_block, math.ceil(steps / block), graphed,
                         done=lambda: bool((s.stop | (s.i >= s.ref_len))
                                           .all()), device=refs.device)
    if counts is not None:
        counts["steps"] = counts.get("steps", 0) + ran * block
        counts["blocks"] = counts.get("blocks", 0) + ran
    # read end: SMALLEST j attaining the max in the best column
    # (ssw.c:285-291 takes min over the striped scan)
    hit = (s.Hbest == s.best[:, None]) & s.valid
    end_read = torch.where(hit, s.jidx, Lread + 1).amin(1)
    end_read = torch.where(s.best > 0, end_read, read_len.int() - 1)
    return s.best, s.best_i, end_read, s.maxcol[:, :Lref]


def _second_best(maxcol: np.ndarray, end_ref: int, mask_len: int,
                 ref_len: int) -> Tuple[int, int]:
    """bests[1] (ssw.c:310-325): best column outside the maskLen window
    around end_ref, strict > keeps the first."""
    score2, ref2 = 0, 0
    edge = max(end_ref - mask_len, 0)
    for i in range(edge):
        if maxcol[i] > score2:
            score2, ref2 = int(maxcol[i]), i
    edge = min(end_ref + mask_len, ref_len)
    for i in range(edge + 1, ref_len):
        if maxcol[i] > score2:
            score2, ref2 = int(maxcol[i]), i
    return score2, ref2


def _banded_sw(ref: np.ndarray, read: np.ndarray, score: int,
               gapO: int, gapE: int, band_width: int,
               mat: np.ndarray) -> List[Tuple[int, str]]:
    """Exact banded_sw port (ssw.c:532-717): direction codes 1=M,
    2=E-ext, 3=E-open, 4=F-ext, 5=F-open; traceback from the last cell
    with its h/e/f state machine; band doubling until max >= score."""
    refLen, readLen = len(ref), len(read)
    while True:
        width = band_width * 2 + 3
        width_d = band_width * 2 + 1
        h_b = np.zeros(width, np.int64)
        e_b = np.zeros(width, np.int64)
        h_c = np.zeros(width, np.int64)
        direction = np.zeros((readLen, width_d * 3), np.int8)
        maxv = 0
        for i in range(readLen):
            beg = max(0, i - band_width)
            end = min(refLen - 1, i + band_width)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            dline = direction[i]
            x0 = max(i - band_width, 0)
            x1 = max(i - 1 - band_width, 0)
            u_last = 0
            for j in range(beg, end + 1):
                u = j - x0 + 1
                e_ = j - x1 + 1
                b = j - 1 - x0 + 1
                d = j - 1 - x1 + 1
                de, df, dh = (j - x0) * 3, (j - x0) * 3 + 1, \
                    (j - x0) * 3 + 2
                t1 = -gapO if i == 0 else h_b[e_] - gapO
                t2 = -gapE if i == 0 else e_b[e_] - gapE
                e_b[u] = max(t1, t2)
                dline[de] = 3 if t1 > t2 else 2
                t1 = h_c[b] - gapO
                t2 = f - gapE
                f = max(t1, t2)
                dline[df] = 5 if t1 > t2 else 4
                e1 = max(e_b[u], 0)
                f1 = max(f, 0)
                t1 = max(e1, f1)
                t2 = h_b[d] + mat[ref[j], read[i]]
                h_c[u] = max(t1, t2)
                maxv = max(maxv, h_c[u])
                if t1 <= t2:
                    dline[dh] = 1
                else:
                    dline[dh] = dline[de] if e1 > f1 else dline[df]
                u_last = u
            h_b[1:u_last + 1] = h_c[1:u_last + 1]
        if maxv >= score:
            break
        band_width *= 2

    # traceback (ssw.c:621-666)
    i, j = readLen - 1, refLen - 1
    e = 0
    ops: List[Tuple[int, str]] = []
    op = prev_op = "M"
    state = 2
    while i > 0:
        x = max(i - band_width, 0)
        code = direction[i][(j - x) * 3 + state]
        if code == 1:
            i -= 1
            j -= 1
            state = 2
            op = "M"
        elif code == 2:
            i -= 1
            state = 0
            op = "I"
        elif code == 3:
            i -= 1
            state = 2
            op = "I"
        elif code == 4:
            j -= 1
            state = 1
            op = "D"
        elif code == 5:
            j -= 1
            state = 2
            op = "D"
        else:
            return []                       # "not consensus" path
        if op == prev_op:
            e += 1
        else:
            ops.append((e, prev_op))
            prev_op = op
            e = 1
    if op == "M":
        ops.append((e + 1, op))
    else:
        ops.append((e, op))
        ops.append((1, "M"))
    ops.reverse()
    return ops


class SswAligner:
    """Batched ssw_align with the realigner's scoring defaults
    (realigner.cpp:64-73), its sweeps on `device` (the card unless asked
    for the CPU)."""

    def __init__(self, match: int = 4, mismatch: int = 6,
                 gap_open: int = 8, gap_extend: int = 2, *,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.match, self.mismatch = match, mismatch
        self.gapO, self.gapE = gap_open, gap_extend
        self.mat = default_matrix(match, mismatch)
        self._matt = torch.from_numpy(self.mat).to(self.device)

    def _run(self, refs, reads, rfl, rdl, terminate, Lref, Lread,
             graphed, counts):
        dev = self.device
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (refs, reads, rfl, rdl, terminate)]
        out = _sweep(*t[:4], self._matt, t[4], Lref, Lread, self.gapO,
                     self.gapE, False, graphed=graphed, counts=counts)
        return [o.cpu().numpy() for o in out]

    def align_batch(self, reads: List[str], refs: List[str],
                    mask_len: Optional[int] = None,
                    with_cigar: bool = True, *,
                    graphed: Optional[bool] = None,
                    stats: Optional[dict] = None) -> List[SswAlignment]:
        """ssw_align for every (read, ref) pair: batched device forward
        pass, batched reverse pass over the best prefixes, host banded
        cigar.  graphed=False runs the sweeps' blocks eagerly on the card
        too; `stats`, a dict, gets each pass's steps and blocks and the
        (Lref, Lread) shape."""
        B = len(reads)
        if B == 0:
            return []
        rd = [_ENC[np.frombuffer(s.encode(), np.uint8)] for s in reads]
        rf = [_ENC[np.frombuffer(s.encode(), np.uint8)] for s in refs]
        Lread = _pow2(max(len(s) for s in rd))
        Lref = _pow2(max(len(s) for s in rf))
        reads_a = np.full((B, Lread), 4, np.int8)
        refs_a = np.full((B, Lref), 4, np.int8)
        rdl = np.zeros(B, np.int32)
        rfl = np.zeros(B, np.int32)
        for b in range(B):
            reads_a[b, :len(rd[b])] = rd[b]
            refs_a[b, :len(rf[b])] = rf[b]
            rdl[b], rfl[b] = len(rd[b]), len(rf[b])

        fwd, rev = {}, {}
        with torch.profiler.record_function("ssw.sweep"):
            best, best_i, end_read, maxcol = self._run(
                refs_a, reads_a, rfl, rdl, np.zeros(B, np.int32), Lref,
                Lread, graphed, fwd)

        # reverse pass: reversed read prefix vs reversed ref prefix,
        # terminated at score1 (ssw.c:820-833)
        rev_reads = np.full((B, Lread), 4, np.int8)
        rev_refs = np.full((B, Lref), 4, np.int8)
        rev_rdl = np.zeros(B, np.int32)
        rev_rfl = np.zeros(B, np.int32)
        for b in range(B):
            er, err = int(best_i[b]), int(end_read[b])
            rev_reads[b, :err + 1] = rd[b][err::-1]
            rev_refs[b, :er + 1] = rf[b][er::-1]
            rev_rdl[b], rev_rfl[b] = err + 1, er + 1
        with torch.profiler.record_function("ssw.sweep"):
            _, rbest_i, rend_read, _ = self._run(
                rev_refs, rev_reads, rev_rfl, rev_rdl, best, Lref, Lread,
                graphed, rev)
        if stats is not None:
            stats.update(Lref=Lref, Lread=Lread, pairs=B,
                         fwd_steps=fwd["steps"], fwd_blocks=fwd["blocks"],
                         rev_steps=rev.get("steps", 0),
                         rev_blocks=rev.get("blocks", 0))

        out = []
        for b in range(B):
            ml = mask_len if mask_len is not None else len(rd[b])
            score1 = int(best[b])
            ref_end = int(best_i[b])
            read_end = int(end_read[b])
            # reversed coordinates back to forward (ssw.c:830-832)
            ref_begin = ref_end - int(rbest_i[b])
            read_begin = read_end - int(rend_read[b])
            if ml >= 15:
                score2, ref2 = _second_best(maxcol[b], ref_end, ml,
                                            int(rfl[b]))
            else:
                score2, ref2 = 0, -1
            cig: List[Tuple[int, str]] = []
            if with_cigar and score1 > 0:
                sub_ref = rf[b][ref_begin:ref_end + 1]
                sub_read = rd[b][read_begin:read_end + 1]
                bw = abs(len(sub_ref) - len(sub_read)) + 1
                cig = _banded_sw(sub_ref, sub_read, score1,
                                 self.gapO, self.gapE, bw, self.mat)
            out.append(SswAlignment(
                score1=score1, score2=score2,
                ref_begin1=ref_begin, ref_end1=ref_end,
                read_begin1=read_begin, read_end1=read_end,
                ref_end2=ref2, cigar=cig))
        return out

    def align(self, read: str, ref: str, **kw) -> SswAlignment:
        return self.align_batch([read], [ref], **kw)[0]


def _pow2(v: int, lo: int = 16) -> int:
    p = lo
    while p < v:
        p *= 2
    return p
