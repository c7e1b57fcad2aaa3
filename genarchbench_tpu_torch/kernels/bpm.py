"""Bit-Parallel Myers (BPM) edit distance and the BitPAL scores.

Reference semantics: bpm/edit/edit_bpm.c (`BPM_ADVANCE_BLOCK` :47-67,
`edit_bpm_compute_matrix` :190-270): Myers' 1999 blocked bit-vector
recurrence; the benchmark program (tools/align_benchmark.c:444) reports
the global edit distance of pattern (longer seq) vs text per pair.

The host side is the JAX package's (kernels/bpm.py): reading, the PEQ
build in numpy, 32-bit words.  The DP runs on the device: bpm-edit
through the CUDA kernel (bpm_cuda.py, csrc/bpm.cu), the BitPAL
algorithms as torch ops.  Pairs are grouped by word count W only: the
kernel loops to each pair's own text length, so the JAX package's pow2
padding of batch and text length (there to bound TPU recompiles) is
gone, and one launch serves every pair of a word count.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import ROITimer
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, read_seqpairs
from genarchbench_tpu_torch.kernels.bpm_cuda import bpm_distance

W32 = 32


def compile_peq(patterns: Sequence[np.ndarray], W: int) -> np.ndarray:
    """Host-side PEQ build: (B, W, 4) uint32 match-bit masks.

    Padding rows (>= plen) are set for every character, mirroring
    edit_bpm_pattern_compile (edit_bpm.c:108-116); they cannot influence
    the score bit (carries only propagate upward) but keep parity.
    """
    B = len(patterns)
    P = W * W32
    codes = np.full((B, P), 4, np.uint8)
    for i, p in enumerate(patterns):
        codes[i, :len(p)] = p
    pos = np.arange(P)
    bits = (np.uint32(1) << (pos % W32).astype(np.uint32))
    onehot = (codes[:, :, None] == np.arange(4, dtype=np.uint8)) | (codes[:, :, None] == 4)
    contrib = np.where(onehot, bits[None, :, None], np.uint32(0))
    return np.bitwise_or.reduce(
        contrib.reshape(B, W, W32, 4), axis=2).astype(np.uint32)


def kernel_inputs(pairs: SeqPairs) -> List[Tuple[np.ndarray, Tuple[np.ndarray, ...]]]:
    """The kernel's inputs, one group per word count W:
    [(pair indices, (peq (W,4,B) int32 bits, plen (B,) int32,
    text (T,B) int8, tlen (B,) int32))]."""
    groups = defaultdict(list)
    for i in range(len(pairs)):
        groups[max(1, -(-len(pairs.patterns[i]) // W32))].append(i)
    out = []
    for W, idxs in sorted(groups.items()):
        pats = [pairs.patterns[i] for i in idxs]
        txts = [pairs.texts[i] for i in idxs]
        B = len(idxs)
        peq = compile_peq(pats, W).view(np.int32).transpose(1, 2, 0)
        plen = np.array([len(p) for p in pats], np.int32)
        tlen = np.array([len(t) for t in txts], np.int32)
        text = np.zeros((max(int(tlen.max()), 1), B), np.int8)
        for b, t in enumerate(txts):
            text[:len(t), b] = t
        out.append((np.asarray(idxs), (np.ascontiguousarray(peq), plen,
                                       text, tlen)))
    return out


def bpm_batch(pairs: SeqPairs, device: Optional[str] = None) -> np.ndarray:
    """Edit distance for every pair; returns (n,) int32 in input order."""
    dev = resolve_device(device)
    out = np.zeros(len(pairs), np.int32)
    for idxs, arrays in kernel_inputs(pairs):
        score = bpm_distance(*(torch.from_numpy(a).to(dev) for a in arrays))
        out[idxs] = score.cpu().numpy()
    return out


def _bitpal_device(pat, txt, plen, tlen, L, m_sc, x_sc, g_sc):
    """Batched GLOBAL alignment score with linear gaps — the quantity
    BitPAL's delta-packed last-row accumulation computes
    (bitpal/bitpal.m0.x1.g1.c returns -edit distance; m1.x4.g2 the
    match=1/mismatch=-4/gap=-2 score).  Row scan over the pattern; the
    in-row chain H[i][j-1]+g closes into ONE running-max scan of
    pre[j'] - j'*g (same trick as the SSW column sweep)."""
    B = pat.shape[0]
    dev = pat.device
    i64 = torch.int64
    jidx = torch.arange(L + 1, dtype=i64, device=dev)[None, :]
    NEGB = -(1 << 28)
    tl = tlen[:, None]
    H = torch.where(jidx <= tl, jidx * g_sc, NEGB)
    for i in range(L):
        pb = pat[:, i][:, None]                            # (B,1)
        s = torch.where(txt == pb, m_sc, x_sc)             # (B,L)
        diag = H[:, :-1] + s                               # -> cells j=1..L
        up = H[:, 1:] + g_sc
        pre = torch.maximum(diag, up)
        pre0 = torch.full((B, 1), (i + 1) * g_sc, dtype=i64, device=dev)
        pre = torch.cat([pre0, pre], dim=1)                # (B, L+1)
        cm = torch.cummax(pre - jidx * g_sc, dim=1).values
        Hn = torch.where(jidx <= tl, cm + jidx * g_sc, NEGB)
        H = torch.where(i < plen[:, None], Hn, H)
    return H.gather(1, tl)[:, 0]


def bitpal_batch(pairs: SeqPairs, m_sc: int, x_sc: int, g_sc: int,
                 max_batch: int = 8192,
                 device: Optional[str] = None) -> np.ndarray:
    """Scores for the bitpal-edit / bitpal-scored algorithms
    (benchmark_bitpal.c:30-52), batched by length."""
    dev = resolve_device(device)
    n = len(pairs)
    out = np.zeros(n, np.int64)
    order = np.argsort([max(len(pairs.patterns[i]), len(pairs.texts[i]))
                        for i in range(n)], kind="stable")
    for lo in range(0, n, max_batch):
        chunk = order[lo:lo + max_batch]
        L = max(1, max(max(len(pairs.patterns[i]), len(pairs.texts[i]))
                       for i in chunk))
        B = len(chunk)
        pat = np.full((B, L), 254, np.int64)
        txt = np.full((B, L), 255, np.int64)
        plen = np.zeros(B, np.int64)
        tlen = np.zeros(B, np.int64)
        for b, i in enumerate(chunk):
            p_, t_ = pairs.patterns[i], pairs.texts[i]
            pat[b, :len(p_)] = p_
            txt[b, :len(t_)] = t_
            plen[b], tlen[b] = len(p_), len(t_)
        args = (torch.from_numpy(a).to(dev) for a in (pat, txt, plen, tlen))
        sc = _bitpal_device(*args, L=L, m_sc=m_sc, x_sc=x_sc, g_sc=g_sc)
        out[chunk] = sc.cpu().numpy()
    return out


def cell_updates(pairs: SeqPairs) -> int:
    return sum(len(p) * len(t) for p, t in zip(pairs.patterns, pairs.texts))


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference align_benchmark (bpm):
    -a bpm-edit -i input -o output -t threads."""
    import argparse
    p = argparse.ArgumentParser(prog="bpm")
    p.add_argument("-a", dest="algorithm", default="bpm-edit",
                   choices=["bpm-edit", "bitpal-edit", "bitpal-scored"])
    p.add_argument("-i", dest="input", required=True)
    p.add_argument("-o", dest="output", default=None)
    p.add_argument("-t", dest="threads", type=int, default=1)
    args = p.parse_args(argv)

    dev = resolve_device()
    pairs = read_seqpairs(args.input, swap_longer_first=True)
    roi = ROITimer("bpm", "=> Time.Benchmark      {t:.2f} s")
    with roi:
        if args.algorithm == "bitpal-edit":
            scores = bitpal_batch(pairs, 0, -1, -1, device=dev)
        elif args.algorithm == "bitpal-scored":
            scores = bitpal_batch(pairs, 1, -4, -2, device=dev)
        else:
            scores = bpm_batch(pairs, device=dev)
        roi.sync(scores)
    print("[Benchmark]", file=sys.stderr)
    print(f"=> Total.reads            {len(pairs)}", file=sys.stderr)
    roi.report()
    cells = cell_updates(pairs)
    if roi.elapsed > 0:
        print(f"=> CellUpdates            {cells} "
              f"({cells / roi.elapsed:.3e} cells/s)", file=sys.stderr)

    if args.output:
        # bpm-edit prints the NEGATED edit distance (benchmark_edit.c:49);
        # the bitpal algorithms print their scores directly
        neg = args.algorithm == "bpm-edit"
        with open(args.output, "w") as f:
            f.writelines(f"[{i}] score={-s if neg else s}\n"
                         for i, s in enumerate(scores))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
