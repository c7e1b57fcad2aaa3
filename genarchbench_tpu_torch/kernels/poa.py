"""poa: partial-order alignment consensus (spoa) as torch ops.

Reference semantics: the poa/src/msa_spoa_omp.cpp program (batch format
:99-127, engine params m=2,x=-4,o=-4,e=-2,o2=-24,e2=-1 => convex NW
:169-215, output :371-375) over the bundled spoa library
(spoa.tar.bz2): graph add_alignment / aligned-node fusion
(graph.cpp:117-270), iterative-DFS topological sort with aligned-node
grouping (:293-352), heaviest-bundle consensus with branch completion
(:494-586), and the convex Needleman-Wunsch DP + traceback priorities
of SisdAlignmentEngine::convex (sisd_alignment_engine.cpp:94-230
boundary conditions, :600-912 DP & backtrack).

The design is the JAX package's (kernels/poa.py), which has no Pallas
kernel:
  * the graph (aligned-node fusion, the topological sort, the
    heaviest-bundle consensus) stays on the host, in C
    (`native/poa_graph.c`, `NativeGraph`); `Graph` is its plain version
    in Python, which the tests hold it to;
  * all windows of a run align their s-th read in lock-step: a round is
    one dispatch per predecessor-width bucket, and a dispatch runs the
    convex NW DP over a (G, R, W) window batch, one rank a step with
    every query column at once, emitting two int32 traceback code
    planes a cell;
  * a lock-step walk over the planes on the device returns each
    window's path, so only (G, steps) int16 paths come back.

What differs from JAX: the closed-form row takes each exclusive prefix
max as one `torch.cummax`; the general max-plus row scan is a
Hillis-Steele doubling; the code planes take the lowest hitting
predecessor slot by an int32 argmax over P in place of a loop.  Both
loops run in blocks of BLOCK steps (`core/blocks.py`): a DP step reads
its row's inputs at a row index held in a device tensor and writes the
row by `index_copy_`, a walk step writes its emission at a device-held
slot, and nothing asks the host, so on the card one block is captured
as a CUDA graph and replayed; on the CPU the same blocks run eagerly.
The DP runs the dispatch's largest rank count rounded up to whole
blocks: the extra rows are padding rows, which no real row reads.  The
walk reads its `fin` flags once a block.  The inputs travel as named
tensors, not JAX's one flat blob, and the group count is not padded.
"""

from __future__ import annotations

import ctypes
import math
import sys
from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.blocks import run_blocks
from genarchbench_tpu_torch.core.roi import Laps, ROITimer, span
from genarchbench_tpu_torch.sharding.batching import next_pow2

NEG = -(1 << 28)         # kNegativeInfinity stand-in (int32-safe)
BLOCK = 8                # DP rows or walk steps a block (a CUDA graph's
                         # length)
MAX_ROW_INDEX = 2047     # row indices are 11-bit fields of the planes


# ---------------------------------------------------------------------------
# graph (exact spoa semantics, host side)
# ---------------------------------------------------------------------------

class Node:
    __slots__ = ("id", "code", "in_edges", "out_edges", "aligned")

    def __init__(self, id_, code):
        self.id = id_
        self.code = code
        self.in_edges: List["Edge"] = []
        self.out_edges: List["Edge"] = []
        self.aligned: List[int] = []


class Edge:
    __slots__ = ("begin", "end", "labels", "weight")

    def __init__(self, begin, end, label, weight):
        self.begin = begin
        self.end = end
        self.labels = [label]
        self.weight = weight


class Graph:
    """spoa's graph in Python: the plain version of `NativeGraph`."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.rank_to_node_id: List[int] = []
        self.num_sequences = 0
        self.num_codes = 0
        self.coder = {}
        self.decoder = {}
        self.sequences_begin: List[int] = []
        self.consensus: List[int] = []

    def add_node(self, code) -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, code))
        return nid

    def add_edge(self, begin, end, weight) -> None:
        for e in self.nodes[begin].out_edges:
            if e.end == end:
                e.labels.append(self.num_sequences)
                e.weight += weight
                return
        e = Edge(begin, end, self.num_sequences, weight)
        self.nodes[begin].out_edges.append(e)
        self.nodes[end].in_edges.append(e)

    def _add_sequence(self, seq, weights, begin, end) -> int:
        if begin == end:
            return -1
        first = self.add_node(self.coder[seq[begin]])
        for i in range(begin + 1, end):
            nid = self.add_node(self.coder[seq[i]])
            self.add_edge(nid - 1, nid, weights[i - 1] + weights[i])
        return first

    def add_alignment(self, alignment, seq: str,
                      weights: Optional[List[int]] = None) -> None:
        """graph.cpp:156-271."""
        n = len(seq)
        if n == 0:
            return
        weights = weights or [1] * n
        for ch in seq:
            if ch not in self.coder:
                self.coder[ch] = self.num_codes
                self.decoder[self.num_codes] = ch
                self.num_codes += 1

        if not alignment:
            begin_id = self._add_sequence(seq, weights, 0, n)
            self.num_sequences += 1
            self.sequences_begin.append(begin_id)
            self.topological_sort()
            return

        valid = [q for (_nid, q) in alignment if q != -1]
        tmp = len(self.nodes)
        begin_id = self._add_sequence(seq, weights, 0, valid[0])
        head = -1 if tmp == len(self.nodes) else len(self.nodes) - 1
        tail = self._add_sequence(seq, weights, valid[-1] + 1, n)

        new_id = -1
        prev_w = 0 if head == -1 else weights[valid[0] - 1]
        for (nid, q) in alignment:
            if q == -1:
                continue
            letter = seq[q]
            if nid == -1:
                new_id = self.add_node(self.coder[letter])
            else:
                if self.decoder[self.nodes[nid].code] == letter:
                    new_id = nid
                else:
                    aligned_to = -1
                    for aid in self.nodes[nid].aligned:
                        if self.decoder[self.nodes[aid].code] == letter:
                            aligned_to = aid
                            break
                    if aligned_to == -1:
                        new_id = self.add_node(self.coder[letter])
                        for aid in self.nodes[nid].aligned:
                            self.nodes[new_id].aligned.append(aid)
                            self.nodes[aid].aligned.append(new_id)
                        self.nodes[new_id].aligned.append(nid)
                        self.nodes[nid].aligned.append(new_id)
                    else:
                        new_id = aligned_to
            if begin_id == -1:
                begin_id = new_id
            if head != -1:
                self.add_edge(head, new_id, prev_w + weights[q])
            head = new_id
            prev_w = weights[q]
        if tail != -1:
            self.add_edge(head, tail, prev_w + weights[valid[-1] + 1])

        self.num_sequences += 1
        self.sequences_begin.append(begin_id)
        self.topological_sort()

    def topological_sort(self) -> None:
        """Iterative DFS with aligned-node grouping (graph.cpp:293-352);
        the exact visit order defines ranks, which the DP depends on."""
        self.rank_to_node_id = []
        marks = [0] * len(self.nodes)
        check_aligned = [True] * len(self.nodes)
        for i in range(len(self.nodes)):
            if marks[i] != 0:
                continue
            stack = [i]
            while stack:
                nid = stack[-1]
                valid = True
                if marks[nid] != 2:
                    for e in self.nodes[nid].in_edges:
                        if marks[e.begin] != 2:
                            stack.append(e.begin)
                            valid = False
                    if check_aligned[nid]:
                        for aid in self.nodes[nid].aligned:
                            if marks[aid] != 2:
                                stack.append(aid)
                                check_aligned[aid] = False
                                valid = False
                    if valid:
                        marks[nid] = 2
                        if check_aligned[nid]:
                            self.rank_to_node_id.append(nid)
                            for aid in self.nodes[nid].aligned:
                                self.rank_to_node_id.append(aid)
                    else:
                        marks[nid] = 1
                if valid:
                    stack.pop()

    # ---- DP-prep / walk interface (shared with NativeGraph) ----

    def num_ranks(self) -> int:
        return len(self.rank_to_node_id)

    def rank_ids(self):
        return self.rank_to_node_id

    def max_in_edges(self) -> int:
        return max((len(self.nodes[nid].in_edges)
                    for nid in self.rank_to_node_id), default=0)

    def export_dp(self, P: int, g_: int, e_: int, q_: int, c_: int):
        """(codes R, preds RxP, npred R, endmask R, O0 R+1, F0 R+1):
        rank-ordered DP prep incl. the column-0 boundary series."""
        rank = self.rank_to_node_id
        R = len(rank)
        codes = np.zeros(R, np.int32)
        preds = np.zeros((R, P), np.int32)
        npred = np.ones(R, np.int32)
        endmask = np.zeros(R, bool)
        O0 = np.full(R + 1, NEG, np.int64)
        F0 = np.full(R + 1, NEG, np.int64)
        O0[0] = 0
        F0[0] = 0
        id_to_rank = {nid: r for r, nid in enumerate(rank)}
        for r, nid in enumerate(rank):
            node = self.nodes[nid]
            codes[r] = ord(self.decoder[node.code])
            endmask[r] = not node.out_edges
            es = node.in_edges
            if not es:
                penO, penF = q_ - c_, g_ - e_
            else:
                npred[r] = len(es)
                penO = penF = None
                for p, ed in enumerate(es):
                    pi = id_to_rank[ed.begin] + 1
                    preds[r, p] = pi
                    penO = O0[pi] if penO is None else max(penO, O0[pi])
                    penF = F0[pi] if penF is None else max(penF, F0[pi])
            O0[r + 1] = penO + c_
            F0[r + 1] = penF + e_
        return codes, preds, npred, endmask, O0, F0

    def add_walk(self, walk, seq: str) -> None:
        """Consume a raw device walk ((ei, ej) int16 arrays in reverse
        step order, or None for the no-alignment case)."""
        if walk is None:
            self.add_alignment([], seq)
            return
        ei, ej = walk
        rank = self.rank_to_node_id
        path = [(rank[int(a) - 1] if a > 0 else -1,
                 int(b) if b >= 0 else -1)
                for a, b in zip(ei, ej)]
        path.reverse()
        self.add_alignment(path, seq)

    def generate_consensus(self) -> str:
        self._traverse_heaviest_bundle()
        return "".join(self.decoder[self.nodes[nid].code]
                       for nid in self.consensus)

    def _traverse_heaviest_bundle(self) -> None:
        """graph.cpp:494-541."""
        n = len(self.nodes)
        predecessors = [-1] * n
        scores = [-1] * n
        max_id = 0
        for nid in self.rank_to_node_id:
            for e in self.nodes[nid].in_edges:
                if (scores[nid] < e.weight
                        or (scores[nid] == e.weight
                            and scores[predecessors[nid]] <= scores[e.begin])):
                    scores[nid] = e.weight
                    predecessors[nid] = e.begin
            if predecessors[nid] != -1:
                scores[nid] += scores[predecessors[nid]]
            if scores[max_id] < scores[nid]:
                max_id = nid

        if self.nodes[max_id].out_edges:
            id_to_rank = [0] * n
            for r, nid in enumerate(self.rank_to_node_id):
                id_to_rank[nid] = r
            while self.nodes[max_id].out_edges:
                max_id = self._branch_completion(scores, predecessors,
                                                id_to_rank[max_id])

        self.consensus = []
        while predecessors[max_id] != -1:
            self.consensus.append(max_id)
            max_id = predecessors[max_id]
        self.consensus.append(max_id)
        self.consensus.reverse()

    def _branch_completion(self, scores, predecessors, rank) -> int:
        """graph.cpp:544-586."""
        nid0 = self.rank_to_node_id[rank]
        for e in self.nodes[nid0].out_edges:
            for oe in self.nodes[e.end].in_edges:
                if oe.begin != nid0:
                    scores[oe.begin] = -1
        max_score = 0
        max_id = 0
        for i in range(rank + 1, len(self.rank_to_node_id)):
            nid = self.rank_to_node_id[i]
            scores[nid] = -1
            predecessors[nid] = -1
            for e in self.nodes[nid].in_edges:
                if scores[e.begin] == -1:
                    continue
                if (scores[nid] < e.weight
                        or (scores[nid] == e.weight
                            and scores[predecessors[nid]] <= scores[e.begin])):
                    scores[nid] = e.weight
                    predecessors[nid] = e.begin
            if predecessors[nid] != -1:
                scores[nid] += scores[predecessors[nid]]
            if max_score < scores[nid]:
                max_score = scores[nid]
                max_id = nid
        return max_id


class NativeGraph:
    """The C graph (native/poa_graph.c) with `Graph`'s semantics and
    interface; the library is built at first use, and a failed build
    raises."""

    def __init__(self):
        self._lib = native.library()
        self._h = self._lib.poa_new()
        if not self._h:
            raise MemoryError("poa_new: out of memory")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.poa_free(h)

    def num_ranks(self) -> int:
        return int(self._lib.poa_num_ranks(self._h))

    def rank_ids(self):
        R = self.num_ranks()
        out = np.zeros(max(R, 1), np.int32)
        self._lib.poa_get_ranks(self._h, native._ptr(out, ctypes.c_int32))
        return out[:R]

    def max_in_edges(self) -> int:
        return int(self._lib.poa_max_in_edges(self._h))

    def export_dp(self, P: int, g_: int, e_: int, q_: int, c_: int):
        ct = ctypes
        R = self.num_ranks()
        codes = np.zeros(max(R, 1), np.int32)
        preds = np.zeros((max(R, 1), P), np.int32)
        npred = np.ones(max(R, 1), np.int32)
        endmask = np.zeros(max(R, 1), np.uint8)
        O0 = np.full(R + 1, NEG, np.int64)
        F0 = np.full(R + 1, NEG, np.int64)
        self._lib.poa_export_dp(
            self._h, P, native._ptr(codes, ct.c_int32),
            native._ptr(preds, ct.c_int32), native._ptr(npred, ct.c_int32),
            native._ptr(endmask, ct.c_uint8), native._ptr(O0, ct.c_int64),
            native._ptr(F0, ct.c_int64), g_, e_, q_, c_)
        return (codes[:R], preds[:R], npred[:R],
                endmask[:R].astype(bool), O0, F0)

    def add_walk(self, walk, seq: str) -> None:
        ct = ctypes
        sb = np.frombuffer(seq.encode(), np.uint8)
        if walk is None or len(walk[0]) == 0:
            rc = self._lib.poa_add_alignment(
                self._h, None, None, 0, native._ptr(sb, ct.c_uint8), len(sb),
                0)
        else:
            ei = np.ascontiguousarray(walk[0], np.int16)
            ej = np.ascontiguousarray(walk[1], np.int16)
            if ei.shape != ej.shape:
                raise ValueError(f"walk halves differ in length: "
                                 f"{ei.shape} vs {ej.shape}")
            rc = self._lib.poa_add_alignment(
                self._h, native._ptr(ei, ct.c_int16),
                native._ptr(ej, ct.c_int16), len(ei),
                native._ptr(sb, ct.c_uint8), len(sb), 1)
        if rc != 0:
            raise RuntimeError("poa_add_alignment failed")

    def generate_consensus(self) -> str:
        cap = max(self.num_ranks() + 2, 2)
        out = np.zeros(cap, np.uint8)
        m = self._lib.poa_consensus(self._h,
                                    native._ptr(out, ctypes.c_uint8),
                                    cap)
        return out[:m].tobytes().decode()


def new_graph() -> NativeGraph:
    """An empty C graph (the library built at first use)."""
    return NativeGraph()


# ---------------------------------------------------------------------------
# convex NW DP and walk (device)
# ---------------------------------------------------------------------------

def _round_up_mult(v: int, m: int) -> int:
    return max(m, ((v + m - 1) // m) * m)


def _maxplus_scan(pre, M0):
    """The general (H, E, Q) row recurrence (`_convex_dp_codes` :572-604):
    s_j = M (x) s_{j-1} (+) (pre_j, NEG, NEG) as an inclusive max-plus
    scan of (W1, 3, 3) matrices, by Hillis-Steele doubling with JAX's
    `compose` (b after a, clamped at NEG).  With every penalty <= 0 the
    clamped compositions equal the clamp of the exact product, whatever
    the order of composition, so the rows equal JAX's associative scan.
    M0 (W1, 3, 3) is M with the all-NEG kill matrix at column 0."""
    G, W1 = pre.shape
    M = M0.expand(G, W1, 3, 3)
    cv = F.pad(pre[..., None], (0, 2), value=NEG)            # (G, W1, 3)
    d = 1
    while d < W1:
        Ma, ca, Mb, cb = M[:, :-d], cv[:, :-d], M[:, d:], cv[:, d:]
        Mo = (Mb[..., :, :, None] + Ma[..., None, :, :]).amax(-2)
        co = torch.maximum((Mb + ca[..., None, :]).amax(-1), cb)
        M = torch.cat([M[:, :d], Mo.clamp_min(NEG)], 1)
        cv = torch.cat([cv[:, :d], co.clamp_min(NEG)], 1)
        d *= 2
    return cv[..., 0].clamp_min(NEG), cv[..., 1:].transpose(1, 2)


# plane1's one-bit fields, in the order `_dp_step` stacks them: diagonal
# found (bit 0), up found (12), up extends (13), left found (25), left
# extends (26), the left extension continues (27); the diagonal and left
# bits are 0 in column 0
_P1_FLAG_BITS = (0, 12, 13, 25, 26, 27)
_P1_FLAG_J0 = (True, False, False, True, True, True)


class _DPState:
    """The DP's carry: H, F and O rows (G, R + 1, 3, W1), the code planes
    (G, R + 1, 2, W1) and the row index i, a 0-dim device tensor; each
    row's inputs (node character, predecessor count, column-0 H, F and
    O, predecessor rows) rank-major in `rowin` (R + 1, G, 5 + P), row 0
    unused; constants and the scratch rows a step writes shifted values
    into (column 0 stays NEG).  R is the rank count padded to whole
    blocks."""

    def __init__(self, node_ch, seq, preds, npred, H0col, F0col, O0col,
                 R, pen):
        m, n, g, e, q, c = pen
        G, R0 = node_ch.shape
        P = preds.shape[2]
        W1 = seq.shape[1]
        dev, i32 = node_ch.device, torch.int32
        self.P, self.W1 = P, W1
        rowin = torch.zeros((R + 1, G, 5 + P), dtype=i32, device=dev)
        rowin[:, :, 0] = -2                  # never equals a query base
        rowin[:, :, 1] = 1
        rowin[:, :, 2:5] = NEG
        rowin[1:R0 + 1, :, 0] = node_ch.T
        rowin[1:R0 + 1, :, 1] = npred.T
        for k, col in enumerate((H0col, F0col, O0col)):
            rowin[1:R0 + 1, :, 2 + k] = col[:, 1:].T
        rowin[1:R0 + 1, :, 5:] = preds.transpose(0, 1)
        self.rowin = rowin
        self.seq = seq.to(i32)

        def const(*v):
            return torch.tensor(v, dtype=i32, device=dev)

        # row-0 boundary series (sisd_alignment_engine.cpp:116-160):
        # E0[j] = g + (j-1)e, Q0[j] = q + (j-1)c, H = max, all 0 at j = 0
        jr = torch.arange(W1, dtype=i32, device=dev)
        E0 = torch.where(jr == 0, 0, g + (jr - 1) * e).to(i32)
        Q0 = torch.where(jr == 0, 0, q + (jr - 1) * c).to(i32)
        H0 = torch.maximum(E0, Q0)
        H0[0] = 0
        self.jec = torch.stack([jr * e, jr * c])
        self.gq0 = torch.stack([g + (jr - 1) * e, q + (jr - 1) * c])
        self.closed = (g <= e <= 0) and (q <= c <= 0) and g <= c and q <= e
        if not self.closed:
            M = const([max(g, q), e, c], [g, e, NEG], [q, NEG, c])
            self.M0 = M.expand(W1, 3, 3).clone()
            self.M0[0] = NEG
        self.m, self.n, self.zero, self.neg = const(m), const(n), const(0), \
            const(NEG)
        self.gq = const(g, q)[:, None]
        self.ec = const(e, c)[:, None]
        self.lsrc = torch.tensor([1, 0, 2, 0], device=dev)   # Es Hs Qs Hs
        self.lpen = const(e, g, c, q)[:, None]
        self.wts = torch.stack([(jr >= 1).to(i32) << b if j0 else
                                torch.full_like(jr, 1 << b) for b, j0 in
                                zip(_P1_FLAG_BITS, _P1_FLAG_J0)])
        self.pshift = const(1 << 1, 1 << 14, 1 << 1, 1 << 12)[:, None]
        self.pslot = torch.arange(P, dtype=i32, device=dev)
        self.pw = P - torch.arange(P, device=dev)
        self.base = (torch.arange(G, device=dev) * (R + 1))[:, None]
        self.sh_p = torch.full((G, P, W1), NEG, dtype=i32, device=dev)
        self.sh_d = torch.full((G, W1), NEG, dtype=i32, device=dev)
        self.sh_2 = torch.full((G, 2, W1), NEG, dtype=i32, device=dev)
        self.sh_3 = torch.full((G, 3, W1), NEG, dtype=i32, device=dev)

        st = torch.full((G, R + 1, 3, W1), NEG, dtype=i32, device=dev)
        st[:, 0, 0] = H0
        for k, col in enumerate((H0col, F0col, O0col)):
            st[:, :R0 + 1, k, 0] = col
        self.state = st
        self.flat = st.view(G * (R + 1), 3 * W1)
        self.planes = torch.zeros((G, R + 1, 2, W1), dtype=i32, device=dev)
        self.planes[:, 0, 0] = (torch.stack(self._left_flags(torch.stack(
            [H0, E0, Q0])[None]), 1) * self.wts[3:]).sum(1)
        self.i = torch.ones((), dtype=torch.int64, device=dev)

    def _left_flags(self, HEQ):
        """The left-move tests of rows HEQ (G, 3, W1) (H, E, Q;
        `_convex_dp_codes` :499-509): left found, left extends, the
        extension continues, each (G, W1) bool."""
        H = HEQ[:, 0]
        sh = self.sh_3[:HEQ.shape[0]]
        sh[:, :, 1:] = HEQ[:, :, :-1]
        lt = sh[:, self.lsrc] + self.lpen == H[:, None]       # l0 l1 l2 l3
        contl = (sh[:, 1:] + self.ec == HEQ[:, 1:]).any(1)
        return lt.any(1), lt[:, 0] | (~lt[:, 1] & lt[:, 2]), contl


def _dp_step(s: _DPState) -> None:
    """DP row i of every window (`_convex_dp_codes`' row_step, :515-657):
    the row's H, F and O and its two code planes."""
    G, P, W1 = s.seq.shape[0], s.P, s.W1
    rin = s.rowin.index_select(0, s.i.view(1))[0]            # (G, 5 + P)
    ch, npred, bnd, preds = rin[:, :1], rin[:, 1:2], rin[:, 2:5], rin[:, 5:]
    X = s.flat.index_select(0, (s.base + preds).view(-1)).view(G, P, 3, W1)
    Hp, FO = X[:, :, 0], X[:, :, 1:]
    ok = s.pslot < npred                                     # (G, P)
    big = torch.where(ok, s.zero, s.neg)[:, :, None]
    HGQ = Hp[:, :, None] + s.gq                              # Hp+g, Hp+q
    FOe = FO + s.ec                                          # Fp+e, Op+c
    FOrow = (torch.maximum(HGQ, FOe) + big[:, :, None]).amax(1)
    prow = torch.where(s.seq == ch, s.m, s.n)
    torch.amax(Hp[:, :, :-1] + big, 1, out=s.sh_d[:, 1:])
    pre = torch.maximum(s.sh_d + prow, FOrow.amax(1))        # diagonal, up
    pre[:, 0] = bnd[:, 0]                                    # col-0 boundary
    # the coupled in-row (H, E, Q) recurrence
    HEQ = torch.empty((G, 3, W1), dtype=torch.int32, device=pre.device)
    if s.closed:
        # under single-gap dominance (:536-571): H_j = max(pre_j, g +
        # (j-1)e + max_{k<j}(pre_k - ke), q + (j-1)c + max_{k<j}(pre_k -
        # kc)), and E, Q from H alone by the same exclusive prefix maxes
        torch.sub(pre[:, None, :-1], s.jec[:, :-1], out=s.sh_2[:, :, 1:])
        A = torch.cummax(s.sh_2, 2).values + s.gq0
        torch.clamp_min(torch.maximum(pre, A.amax(1)), NEG, out=HEQ[:, 0])
        torch.sub(HEQ[:, :1, :-1], s.jec[:, :-1], out=s.sh_2[:, :, 1:])
        torch.clamp_min(torch.cummax(s.sh_2, 2).values + s.gq0, NEG,
                        out=HEQ[:, 1:])
    else:
        H, EQ = _maxplus_scan(pre, s.M0)
        HEQ[:, 0] = H
        HEQ[:, 1:] = EQ
    H = HEQ[:, 0]

    # traceback codes: each field takes the lowest predecessor slot that
    # hits (the reference's if-chain order, :625-642)
    FOrow[:, :, 0] = bnd[:, 1:]                              # stored F, O
    s.sh_p[:, :, 1:] = Hp[:, :, :-1]
    C = torch.cat([(s.sh_p + prow[:, None])[:, :, None], FOe, HGQ], 2)
    eqH = C == H[:, None, None]                              # d c0 c2 c1 c3
    xs = (C[:, :, 1:] == FOrow.repeat(1, 2, 1)[:, None]).view(
        G, P, 2, 2, W1).any(3)                               # x, s
    hits = torch.cat([eqH[:, :, :1], eqH[:, :, 1:].any(2, keepdim=True),
                      xs], 2)                                # (G, P, 4, W1)
    # slot p weighs P - p where it counts: the largest weight is the
    # lowest hitting slot (a max over P in place of an argmax)
    top = (hits * (ok * s.pw)[:, :, None, None]).amax(1)     # (G, 4, W1)
    found = top > 0
    slot = P - top.clamp_min(1)
    pi = torch.gather(preds[:, :, None, None].expand(G, P, 4, W1), 1,
                      slot[:, None])[:, 0] * found * s.pshift
    uext = torch.gather(eqH[:, :, 1] | (~eqH[:, :, 3] & eqH[:, :, 2]), 1,
                        slot[:, 1:2])[:, 0]
    flags = torch.stack([found[:, 0], found[:, 1], uext & found[:, 1],
                         *s._left_flags(HEQ)], 1)
    p1 = (flags * s.wts).sum(1, dtype=torch.int32) + pi[:, 0] + pi[:, 1]
    p2 = found[:, 2] + pi[:, 2] + pi[:, 3]
    s.planes.index_copy_(1, s.i.view(1), torch.stack([p1, p2], 1)[:, None])
    s.state.index_copy_(1, s.i.view(1), torch.cat([H[:, None], FOrow],
                                                  1)[:, None])
    s.i.add_(1)


def _convex_dp_rows(node_ch, seq, preds, npred, H0col, F0col, O0col,
                    endmask, Wlen, nrows: int, pen, block: int = BLOCK,
                    graphed: Optional[bool] = None, counts=None):
    """The convex NW DP of G windows (`_convex_dp_codes`, poa.py:448-670,
    batched over windows): node_ch (G, R) rank characters (-2 on padding
    rows), seq (G, W + 1) query characters (-1 at column 0 and on
    padding), preds (G, R, P) predecessor rows (rank + 1; 0 the virtual
    row), npred (G, R), H0col, F0col, O0col (G, R + 1) the column-0
    boundary, endmask (G, R), Wlen (G,), nrows the ranks to run and pen
    (m, n, g, e, q, c).  The rows run in blocks, graphed on the card by
    default, nrows rounded up to whole blocks.  Returns the code planes
    (G, R' + 1, 2, W + 1) int32 (plane1, plane2 on dimension 2; R' >= R,
    and rows past nrows are padding rows) and start_i (G,) int64."""
    graphed = node_ch.is_cuda if graphed is None else graphed
    G, R = node_ch.shape
    n_blocks = math.ceil(max(nrows, 1) / block)
    s = _DPState(node_ch, seq, preds, npred, H0col, F0col, O0col,
                 max(R, n_blocks * block), pen)

    def run_block():
        for _ in range(block):
            _dp_step(s)

    ran = run_blocks(run_block, n_blocks, graphed, device=node_ch.device)
    # NW start: the last query column, first (rank order) max over end
    # rows (the reference's strict max_score < sc keeps the first, :459-463)
    Hcol = s.state[:, 1:R + 1, 0].gather(
        2, Wlen.long()[:, None, None].expand(G, R, 1))[:, :, 0]
    start = torch.where(endmask.bool(), Hcol, NEG - 1).argmax(1) + 1
    if counts is not None:
        counts.update(dp_rows=ran * block, dp_blocks=ran)
    return s.planes, start


# the walk's code-plane fields (plane, shift, mask): dfound, dpi, uf,
# uext, upi, lf, lext, contl, xfound, xpi, spi (`_convex_dp_codes`
# :464-470)
_FIELDS = ((0, 0, 1), (0, 1, 0x7FF), (0, 12, 1), (0, 13, 1), (0, 14, 0x7FF),
           (0, 25, 1), (0, 26, 1), (0, 27, 1), (1, 0, 1), (1, 1, 0x7FF),
           (1, 12, 0x7FF))
# A step's case: 0 finished, 1 diagonal, 2 up, 3 left, 4 no move (the
# walk ends), 5 an extend-left step, 6 an extend-up step.  A normal step
# (mode 0) takes the first of diagonal, up and left that its cell found
# (:734-741), by dfound * 4 + uf * 2 + lf:
_NORMAL_CASE = (4, 3, 2, 2, 1, 1, 1, 1)
# per case, the columns of the step's candidate stack (i, dpi, upi,
# eu_prev, jx, jx - 1, mode, 0, uext * 2, lext, contl, the extend-up
# mode, -1, -2) that give (ni, nj, nmode, emit_i, emit_j) (:742-758)
_NEXT = ((0, 4, 6, 13, 13), (1, 5, 7, 0, 5), (2, 4, 8, 0, 12),
         (0, 5, 9, 12, 5), (0, 4, 6, 12, 12), (0, 5, 10, 12, 5),
         (3, 4, 11, 0, 12))


class _WalkState:
    """The walk's carry (`_poa_align_device` :716-776): per window the
    row, column and mode (G, 3) and the fin flag, the step t (0-dim), and
    the emissions (G, 2, T) int16, -2 past a window's end."""

    def __init__(self, planes, start_i, Wlen, T):
        G = planes.shape[0]
        self.R, self.W1 = planes.shape[1] - 1, planes.shape[3]
        self.pf = planes.contiguous().view(G, -1)
        dev = planes.device
        self.ijm = torch.stack([start_i.long(), Wlen.long(),
                                torch.zeros_like(start_i, dtype=torch.int64)],
                               1)
        self.fin = Wlen <= 0             # live windows have a query
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.full((G, 2, T), -2, dtype=torch.int16, device=dev)
        self.k = torch.tensor([[0, self.W1]], device=dev)
        f = torch.tensor(_FIELDS, device=dev)
        self.fsrc = f[:, 0]
        self.fshift, self.fmask = f[:, 1].int(), f[:, 2].int()
        self.nsel = torch.tensor([0, 2, 5], device=dev)
        self.nw = torch.tensor([4, 2, 1], device=dev)
        self.ncase = torch.tensor(_NORMAL_CASE, device=dev)
        self.next = torch.tensor(_NEXT, device=dev)
        self.consts = torch.tensor([0, -1, -2], device=dev).expand(G, 3)


def _walk_step(s: _WalkState) -> None:
    """One lock-step traceback step of every window (:716-764); a
    finished window's step changes nothing."""
    i, jx, mode = s.ijm.unbind(1)
    flat = (i.clamp(0, s.R) * (2 * s.W1) + jx.clamp(0, s.W1 - 1))[:, None]
    cc = s.pf.gather(1, flat + s.k)
    f = ((cc[:, s.fsrc] >> s.fshift) & s.fmask).long()      # (G, 11)
    dpi, uext, upi, lext, contl, xf, xpi, spi = (
        f[:, k] for k in (1, 3, 4, 6, 7, 8, 9, 10))
    normal = s.ncase[(f[:, s.nsel] * s.nw).sum(1)]
    case = torch.where(s.fin, 0, torch.where(mode == 0, normal, mode + 4))
    eu_prev = torch.where(xf != 0, xpi, spi)
    cand = torch.cat([torch.stack([
        i, dpi, upi, eu_prev, jx, jx - 1, mode, s.consts[:, 0], uext * 2,
        lext, contl, xf * 2 * (eu_prev != 0)], 1), s.consts[:, 1:]], 1)
    nxt = cand.gather(1, s.next[case])                       # (G, 5)
    s.out.index_copy_(2, s.t.view(1), nxt[:, 3:, None].short())
    s.fin.copy_(s.fin | (case == 4) | (nxt[:, :2] == 0).all(1))
    s.ijm.copy_(nxt[:, :3])
    s.t.add_(1)


def _poa_walk(planes, start_i, Wlen, maxstep: int, block: int = BLOCK,
              graphed: Optional[bool] = None, counts=None):
    """The lock-step walk (`_poa_align_device` :713-776) over the code
    planes (G, R + 1, 2, W + 1) from start_i (G,) at column Wlen (G,):
    outi, outj (G, maxstep) int16 in reverse step order, -2 after each
    window's end.  Graphed on the card by default; the walk runs whole
    blocks until every window has finished or maxstep is reached."""
    graphed = planes.is_cuda if graphed is None else graphed
    n_blocks = math.ceil(maxstep / block)
    s = _WalkState(planes, start_i, Wlen, n_blocks * block)

    def run_block():
        for _ in range(block):
            _walk_step(s)

    ran = run_blocks(run_block, n_blocks, graphed,
                     done=lambda: bool(s.fin.all()), device=planes.device)
    if counts is not None:
        counts.update(walk_steps=ran * block, walk_blocks=ran)
    return s.out[:, 0, :maxstep], s.out[:, 1, :maxstep]


def _add(stats: Optional[dict], **kv) -> None:
    if stats is not None:
        for k, v in kv.items():
            stats[k] = stats.get(k, 0) + v


class ConvexNWEngine:
    """spoa convex kNW engine equivalent (m=2,n=-4,g=-6,e=-2,q=-28,c=-1
    from msa_spoa_omp's o/e translation, msa_spoa_omp.cpp:171-215), on
    `device` (the card unless asked for the CPU)."""

    graphed = True      # False: the same blocks run eagerly on the card
                        # (the comparison chip_smoke.py makes)

    def __init__(self, m=2, n=-4, g=-6, e=-2, q=-28, c=-1, *,
                 device: Optional[str] = None):
        self.m, self.n, self.g, self.e, self.q, self.c = m, n, g, e, q, c
        self.device = resolve_device(device)

    def align(self, seq: str, graph) -> list:
        """Single-window compat wrapper: spoa-exact (node_id, seq_idx)
        path."""
        walk = self.align_many([seq], [graph])[0]
        if walk is None:
            return []
        ei, ej = walk
        rank = graph.rank_ids()
        path = [(int(rank[int(a) - 1]) if a > 0 else -1,
                 int(b) if b >= 0 else -1)
                for a, b in zip(ei, ej)]
        path.reverse()
        return path

    def align_many(self, seqs: List[str], graphs, stats=None) -> list:
        """Align seqs[w] to graphs[w] for every window w in one round
        (one dispatch per predecessor-width bucket).  Returns per window
        the raw walk (ei, ej int16 arrays, reverse step order; rank+1
        row indices) or None for empty graphs/seqs — feed to
        graph.add_walk.  `stats`, when a dict, accumulates the phases'
        seconds and the loops' counts (`_align_group`)."""
        G = len(seqs)
        results: List = [None] * G
        live = [w for w in range(G) if graphs[w].num_ranks() and seqs[w]]
        # bucket windows by predecessor width: one window holding a node
        # with 8 in-edges would otherwise widen every window's rows
        by_p = defaultdict(list)
        for w in live:
            by_p[next_pow2(graphs[w].max_in_edges())].append(w)
        for P, group in by_p.items():
            self._align_group(seqs, graphs, group, P, results, stats)
        return results

    def _align_group(self, seqs, graphs, live, P, results, stats=None):
        """One dispatch: the DP and the walk of the windows `live`, whose
        widest in-degree rounds up to P.
        stats gains export_s (the C graphs' DP arrays), prep_s (the host
        arrays), h2d_s, dp_s, walk_s, d2h_s (the card synchronized at
        each boundary) and the counts dispatches, windows, dp_rows,
        dp_blocks, walk_steps, walk_blocks, cells (rank x query cells of
        the live windows), pred_cells (the same weighted by each rank's
        predecessors) and dp_cells (the padded cells the DP ran)."""
        pen = (self.m, self.n, self.g, self.e, self.q, self.c)
        g_, e_, q_, c_ = pen[2:]
        dev = self.device
        graphed = self.graphed and dev.type == "cuda"
        lap = Laps(stats, dev)
        nranks = [graphs[w].num_ranks() for w in live]
        Rmax = max(nranks)
        Wmax = max(len(seqs[w]) for w in live)
        # the JAX package's bound (its rows padded to 64), so that both
        # refuse the same graphs
        if _round_up_mult(Rmax, 64) + 1 > MAX_ROW_INDEX:
            raise ValueError(
                f"poa: graph with {Rmax} ranks exceeds the 11-bit "
                "row-index budget of the packed traceback planes")
        exports = [graphs[w].export_dp(P, g_, e_, q_, c_) for w in live]
        lap("export_s")

        G, R, W1 = len(live), _round_up_mult(Rmax, BLOCK), Wmax + 1
        node_ch = np.full((G, R), -2, np.int32)
        seq = np.full((G, W1), -1, np.int32)
        preds = np.zeros((G, R, P), np.int32)
        npred = np.ones((G, R), np.int32)
        O0 = np.full((G, R + 1), NEG, np.int64)
        F0 = np.full((G, R + 1), NEG, np.int64)
        endmask = np.zeros((G, R), bool)
        Wlen = np.zeros(G, np.int32)
        cells = pred_cells = 0
        for gi, (w, (codes, pr, npr, em, o0, f0)) in enumerate(
                zip(live, exports)):
            r, W = nranks[gi], len(seqs[w])
            Wlen[gi] = W
            seq[gi, 1:W + 1] = np.frombuffer(seqs[w].encode(), np.uint8)
            node_ch[gi, :r] = codes
            preds[gi, :r] = pr
            npred[gi, :r] = npr
            endmask[gi, :r] = em
            O0[gi, :r + 1] = o0
            F0[gi, :r + 1] = f0
            cells += r * W
            pred_cells += int(npr.sum()) * W
        H0 = np.maximum(O0, F0)
        H0[:, 0] = 0
        lap("prep_s")

        t = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
             for a in (node_ch, seq, preds, npred, H0, F0, O0, endmask, Wlen)]
        lap("h2d_s")
        counts = {}
        with span("poa.dp"):
            planes, start = _convex_dp_rows(*t, Rmax, pen, BLOCK, graphed,
                                            counts)
        lap("dp_s")
        maxstep = Rmax + W1 + 4
        with span("poa.walk"):
            outi, outj = _poa_walk(planes, start, t[-1], maxstep, BLOCK,
                                   graphed, counts)
        lap("walk_s")
        out = torch.stack([outi, outj]).cpu().numpy()
        lap("d2h_s")
        outi, outj = out
        ends = outi == -2
        for gi, w in enumerate(live):
            nstep = int(np.argmax(ends[gi])) if ends[gi].any() else maxstep
            results[w] = (outi[gi, :nstep], outj[gi, :nstep])
        _add(stats, dispatches=1, windows=G, cells=cells,
             pred_cells=pred_cells, dp_cells=G * counts["dp_rows"] * W1,
             **counts)
        return results


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def read_batches(path: str) -> List[List[str]]:
    """msa_spoa_omp.cpp:99-127: header lines whose 2nd char is '0'
    begin a new batch."""
    batches: List[List[str]] = []
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    nline = len(lines)
    while i < nline:
        hdr = lines[i]
        if len(hdr) > 1 and hdr[1] == "0":
            seqs = []
            i += 1
            while i < nline:
                seqs.append(lines[i])
                i += 1
                if i >= nline:
                    break
                nxt = lines[i]
                if len(nxt) > 1 and nxt[1] == "0":
                    break
                i += 1
            batches.append(seqs)
        else:
            i += 1
    return batches


def consensus_for_batches(batches: List[List[str]], engine: ConvexNWEngine,
                          stats: Optional[dict] = None) -> List[str]:
    """Consensus per window, aligning all windows' s-th sequences in
    lock-step rounds (the add_alignment order within each window is
    exactly the reference's sequential order).  `stats`, when a dict,
    gains the engine's phases and counts (`ConvexNWEngine._align_group`),
    update_s (the C graphs taking the walks), consensus_s and rounds."""
    graphs = [new_graph() for _ in batches]
    rounds = max((len(b) for b in batches), default=0)
    for s in range(rounds):
        idx = [w for w, seqs in enumerate(batches) if s < len(seqs)]
        walks = engine.align_many([batches[w][s] for w in idx],
                                  [graphs[w] for w in idx], stats)
        lap = Laps(stats, engine.device)
        for k, w in enumerate(idx):
            graphs[w].add_walk(walks[k], batches[w][s])
        lap("update_s")
    lap = Laps(stats, engine.device)
    out = [g.generate_consensus() for g in graphs]
    lap("consensus_s")
    _add(stats, rounds=rounds)
    return out


def consensus_for_batch(seqs: List[str], engine: ConvexNWEngine) -> str:
    return consensus_for_batches([seqs], engine)[0]


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference msa_spoa_omp
    (msa_spoa_omp.cpp:167-215); runs on the card unless
    GENARCH_DEVICE=cpu."""
    import argparse
    p = argparse.ArgumentParser(prog="poa")
    p.add_argument("-s", dest="seq_file", default="seq.fa")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-m", type=int, default=2)
    p.add_argument("-x", type=int, default=4)
    p.add_argument("-o", default="4,24")
    p.add_argument("-e", default="2,1")
    p.add_argument("-n", type=int, default=10)
    args = p.parse_args(argv)

    o_parts = [int(t) for t in str(args.o).split(",")]
    e_parts = [int(t) for t in str(args.e).split(",")]
    o1 = -o_parts[0]
    o2 = -(o_parts[1] if len(o_parts) > 1 else 24)
    e1 = -e_parts[0]
    e2 = -(e_parts[1] if len(e_parts) > 1 else 1)
    engine = ConvexNWEngine(m=args.m, n=-args.x,
                            g=o1 + e1, e=e1, q=o2 + e2, c=e2)

    print(f"Running with threads: {args.threads}", file=sys.stderr)
    batches = read_batches(args.seq_file)
    print(f"Number of batches: {len(batches)}, Size of batch struct 64",
          file=sys.stderr)
    roi = ROITimer(
        "poa", "Runtime: {t:.2f}, GraphCreate: 0.00, Align: 0.00, "
        "AddSeqGraph: 0.00, Consensus 0.00 {t:.2f} 0.000 ")
    with roi:
        results = consensus_for_batches(batches, engine)
    for cons in results:
        print(">Consensus_sequence")
        print(cons)
    roi.report()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
