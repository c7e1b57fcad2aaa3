"""Banded affine-gap Smith-Waterman (BWA-MEM2 seed extension).

Reference semantics: the int16 vector path the benchmark actually runs
(bsw/src/bandedSWA.cpp: getScores16 :3478, smithWatermanBatchWrapper16
:3510-3760, smithWaterman128_16 :3766-4150, MAIN_CODE16 :3396), including
its adaptive per-lane head/tail band, group-shared beg/end narrowing,
z-drop (the vector variant WITHOUT the e_del/e_ins scaling of the scalar
code), per-row early exits, and the SORT_PAIRS=1 batch pipeline
(counting-sort by reference length, groups of SIMD width, re-sort by id).

The host side is the JAX package's (kernels/bsw.py): the nibble codes,
`_myband`, and the per-batch stable sort into groups, which decides the
group-shared band and hence the scores.  The DP runs on the device in
one call over every group (bsw_cuda.py, csrc/bsw.cu): the kernel loops
each group to its own row count and band, so the JAX package's shape
buckets and their coalescing (there for TPU recompiles and transfer
latency) are gone, and bases travel unpacked as one byte each.

int16 wraparound never occurs for valid inputs (scores < 2^15), so the
kernel computes in int32.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import ROITimer
from genarchbench_tpu_torch.io.bsw_io import BswPairs, read_bsw_pairs
from genarchbench_tpu_torch.kernels.bsw_cuda import (AMBIG_SENTINEL,
                                                     bsw_scores)

LANES = 8            # SIMD_WIDTH16 of the reference SSE2 build
# base codes on the device: bases 0-3, DUMMY1/DUMMY2 ref/query padding
# (standing in for the reference's 99/100 — only their mutual inequality
# matters), 15 = ambiguous (reference 0xFFFF)
NIB_DUMMY1 = 13
NIB_DUMMY2 = 14


def fill_scmat(match: int, mismatch: int, ambig: int):
    """Default BWA scoring (main_banded.cpp:95-102): +match / -mismatch,
    ambig for any pairing with an ambiguous base."""
    return match, -mismatch, ambig


def _myband(len2: np.ndarray, match: int, end_bonus: int,
            o_ins: int, e_ins: int, o_del: int, e_del: int, w: int) -> np.ndarray:
    """Per-pair band limit (wrapper :3696-3718, double math, int16 temps)."""
    qlen = (len2 * match).astype(np.int64)
    t1 = (qlen + (end_bonus - o_ins)).astype(np.uint16).astype(np.float64)
    mi = np.maximum((t1 / e_ins + 1.0).astype(np.int64), 1)
    band = np.minimum(w, mi)
    t2 = (qlen + (end_bonus - o_del)).astype(np.uint16).astype(np.float64)
    md = np.maximum((t2 / e_del + 1.0).astype(np.int64), 1)
    return np.minimum(band, md).astype(np.int32)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def group_pairs(n: int, len1: np.ndarray, batch_size: int,
                lanes: int) -> np.ndarray:
    """(groups, lanes) source pair indices, -1 for padding: the
    reference's counting sort by reference length within each
    `batch_size` slice, cut into groups of `lanes` (bsw.py:380-392)."""
    if batch_size <= 0:
        batch_size = ((n + lanes - 1) // lanes) * lanes
    rows = []
    for b0 in range(0, n, batch_size):
        idx = np.arange(b0, min(b0 + batch_size, n))
        nb = len(idx)
        pad = _round_up(nb, lanes) - nb
        len1p = np.concatenate([len1[idx], np.zeros(pad, np.int32)])
        srcp = np.concatenate([idx, np.full(pad, -1)])
        order = np.argsort(len1p, kind="stable")                # counting sort
        rows.append(srcp[order].reshape(-1, lanes))
    return np.concatenate(rows) if rows else np.zeros((0, lanes), np.int64)


def _fill(seqs, src: np.ndarray, lens: np.ndarray, width: int,
          dummy: int) -> np.ndarray:
    """(G, L, width) uint8 base codes of the pairs `src` (-1 = padding),
    `dummy` past each length; 0xFFFF (ambiguous) becomes 15."""
    n = len(seqs)
    flat = (np.minimum(np.concatenate(seqs), AMBIG_SENTINEL).astype(np.uint8)
            if n else np.zeros(0, np.uint8))
    flat = np.concatenate([flat, np.zeros(1, np.uint8)])        # clamp slot
    off = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    valid = src >= 0
    safe = np.where(valid, src, 0)
    pos = np.arange(width)[None, None, :]
    vals = flat[np.minimum(off[safe][:, :, None] + pos, len(flat) - 1)]
    inb = valid[:, :, None] & (pos < lens[:, :, None])
    return np.where(inb, vals, dummy).astype(np.uint8)


def kernel_inputs(pairs: BswPairs, batch_size: int, lanes: int, match: int,
                  end_bonus: int, o_ins: int, e_ins: int, o_del: int,
                  e_del: int, w: int) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """The kernel's inputs for every pair: (src (G, lanes), (seq1, seq2,
    len1, len2, h0, myband)), with R and C2 the largest reference length
    and one more than the largest query length, rounded up to 32."""
    n = len(pairs)
    all_len1 = np.fromiter((len(r) for r in pairs.refs), np.int32, n)
    all_len2 = np.fromiter((len(q) for q in pairs.quers), np.int32, n)
    src = group_pairs(n, all_len1, batch_size, lanes)
    valid = src >= 0
    safe = np.where(valid, src, 0)
    myband_all = _myband(all_len2, match, end_bonus, o_ins, e_ins,
                         o_del, e_del, w)
    mb_pad = _myband(np.zeros(1, np.int32), match, end_bonus,
                     o_ins, e_ins, o_del, e_del, w)[0]
    L1 = np.where(valid, all_len1[safe], 0).astype(np.int32)
    L2 = np.where(valid, all_len2[safe], 0).astype(np.int32)
    H0 = np.where(valid, pairs.h0[safe], 0).astype(np.int32)
    MB = np.where(valid, myband_all[safe], mb_pad).astype(np.int32)
    R = _round_up(max(int(all_len1.max(initial=0)), 1), 32)
    C2 = _round_up(int(all_len2.max(initial=0)) + 1, 32)
    s1 = _fill(pairs.refs, src, L1, R, NIB_DUMMY1)
    s2 = _fill(pairs.quers, src, L2, C2, NIB_DUMMY2)
    return src, (s1, s2, L1, L2, H0, MB)


def bsw_batch(pairs: BswPairs, batch_size: int = 512,
              match: int = 1, mismatch: int = 4, ambig: int = -1,
              o_del: int = 6, e_del: int = 1, o_ins: int = 6, e_ins: int = 1,
              zdrop: int = 100, w: int = 100, end_bonus: int = 5,
              lanes: int = LANES, device: Optional[str] = None) -> np.ndarray:
    """Scores for all pairs in input order, replicating the reference's
    batch -> sort-by-len1 -> groups-of-8 pipeline.

    `lanes` is the reference's SIMD group width, which determines group
    membership and hence the group-shared band: SIMD_WIDTH16 = 8 for
    the int16 path (default), SIMD_WIDTH8 = 16 for the int8 path
    (bandedSWA.h:79-80, SSE build) — see run()'s -i8 flag."""
    dev = resolve_device(device)
    scores = np.zeros(len(pairs), np.int32)
    if not len(pairs):
        return scores
    _, mis, amb = fill_scmat(match, mismatch, ambig)
    src, arrays = kernel_inputs(pairs, batch_size, lanes, match, end_bonus,
                                o_ins, e_ins, o_del, e_del, w)
    out = bsw_scores(*(torch.from_numpy(a).to(dev) for a in arrays),
                     match=match, mismatch=mis, ambig=amb, o_del=o_del,
                     e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w=w)
    valid = src >= 0
    scores[src[valid]] = out[0].cpu().numpy()[valid]
    return scores


def cell_updates(pairs: BswPairs, w: int = 100) -> int:
    """Banded DP cells (2w+1 band, like the reference's numCellsComputed)."""
    return sum(min(2 * w + 1, len(q)) * len(r)
               for r, q in zip(pairs.refs, pairs.quers))


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference bsw binary (main_banded.cpp:222):
    -pairs file [-t n] [-b batch] [-match/-mismatch/-gapo/-gape/-ambig/-h0]."""
    import argparse
    p = argparse.ArgumentParser(prog="bsw", prefix_chars="-")
    p.add_argument("-pairs", dest="pairs", required=True)
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-b", dest="batch", type=int, default=0)
    p.add_argument("-match", type=int, default=1)
    p.add_argument("-mismatch", type=int, default=4)
    p.add_argument("-gapo", type=int, default=6)
    p.add_argument("-gape", type=int, default=1)
    p.add_argument("-ambig", type=int, default=-1)
    p.add_argument("-i8", dest="i8", action="store_true",
                   help="int8 kernel semantics (getScores8, "
                        "bandedSWA.cpp:428+): SIMD_WIDTH8=16-lane "
                        "grouping; inputs must fit the reference's "
                        "8-bit row/column indices")
    args = p.parse_args(argv)

    dev = resolve_device()
    pairs = read_bsw_pairs(args.pairs)
    lanes = LANES
    if args.i8:
        # the reference int8 kernel walks rows/cols with int8_t
        # counters and uint8 lengths (smithWaterman128_8,
        # bandedSWA.cpp:5649+): sequences beyond 127 bases or scores
        # reaching 128 would wrap there — refuse such inputs rather
        # than diverge silently
        lmax = max(max((len(r) for r in pairs.refs), default=0),
                   max((len(q) for q in pairs.quers), default=0))
        smax = max((int(h) for h in pairs.h0), default=0) \
            + args.match * lmax
        if lmax > 127 or smax > 127:
            raise ValueError(
                f"-i8: input exceeds the int8 kernel's range "
                f"(max len {lmax}, score bound {smax}; both must be "
                "<= 127)")
        lanes = 16                     # SIMD_WIDTH8, SSE build
    print(f"Number of input pairs: {len(pairs)}")
    roi = ROITimer("bsw", "Overall SW cycles = 0, {t:.2f} s")
    with roi:
        scores = bsw_batch(pairs, batch_size=args.batch,
                           match=args.match, mismatch=args.mismatch,
                           ambig=args.ambig, o_del=args.gapo, e_del=args.gape,
                           o_ins=args.gapo, e_ins=args.gape, lanes=lanes,
                           device=dev)
        roi.sync(scores)
    for i, s in enumerate(scores):
        print(f"[{i}] score={s}", file=sys.stderr)
    roi.report(file=sys.stdout)
    cells = cell_updates(pairs)
    if roi.elapsed > 0:
        print(f"numCellsComputed = {cells} "
              f"({cells / roi.elapsed:.3e} cells/s)")
    print(f"Total Pairs processed: {len(pairs)}")
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
