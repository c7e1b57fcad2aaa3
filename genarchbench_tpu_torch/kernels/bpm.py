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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import ROITimer
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, read_seqpairs
from genarchbench_tpu_torch.kernels.bpm_cuda import bpm_distance
from genarchbench_tpu_torch.sharding.mesh import (Mesh, data_mesh, device_scope,
                                                  gather_shards, mesh_devices,
                                                  shard_args, shard_items)

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


def word_groups(pairs: SeqPairs) -> Dict[int, np.ndarray]:
    """Pair indices by the pattern's 32-bit word count W."""
    groups = defaultdict(list)
    for i in range(len(pairs)):
        groups[max(1, -(-len(pairs.patterns[i]) // W32))].append(i)
    return {W: np.asarray(idxs) for W, idxs in sorted(groups.items())}


def group_arrays(pairs: SeqPairs, idxs: np.ndarray,
                 W: int) -> Tuple[np.ndarray, ...]:
    """The kernel's inputs for the pairs idxs of word count W: peq
    (W, 4, B) int32 bits, plen (B,) int32, text (T, B) int8, tlen (B,)
    int32."""
    pats = [pairs.patterns[i] for i in idxs]
    txts = [pairs.texts[i] for i in idxs]
    B = len(idxs)
    peq = compile_peq(pats, W).view(np.int32).transpose(1, 2, 0)
    plen = np.array([len(p) for p in pats], np.int32)
    tlen = np.array([len(t) for t in txts], np.int32)
    text = np.zeros((max(int(tlen.max()), 1), B), np.int8)
    for b, t in enumerate(txts):
        text[:len(t), b] = t
    return np.ascontiguousarray(peq), plen, text, tlen


def kernel_inputs(pairs: SeqPairs
                  ) -> List[Tuple[np.ndarray, Tuple[np.ndarray, ...]]]:
    """The kernel's inputs, one group per word count W:
    [(pair indices, group_arrays of them)]."""
    return [(idxs, group_arrays(pairs, idxs, W))
            for W, idxs in word_groups(pairs).items()]


def bpm_batch(pairs: SeqPairs, device: Optional[str] = None,
              mesh: Optional[Mesh] = None) -> np.ndarray:
    """Edit distance for every pair; returns (n,) int32 in input order.
    With a mesh, each word count's pairs split over its devices
    (`shard_items`: the reference's static-interleaved OMP distribution,
    bpm/tools/align_benchmark.c:169-204, as contiguous chunks) and the
    kernel runs on each shard: the hand kernel on a card, the plain
    version on a CPU shard.  Every shard's launch goes out before the
    first result is read."""
    devs = mesh_devices(mesh, device)
    out = np.zeros(len(pairs), np.int32)
    for W, idxs in word_groups(pairs).items():
        parts = shard_items(idxs, mesh)
        scores = []
        for dev, part in zip(devs, parts):
            with device_scope(dev):
                scores.append(bpm_distance(
                    *(torch.from_numpy(a).to(dev)
                      for a in group_arrays(pairs, part, W))))
        for part, score in zip(parts, scores):
            out[part] = score.cpu().numpy()
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
                 max_batch: int = 8192, device: Optional[str] = None,
                 mesh: Optional[Mesh] = None) -> np.ndarray:
    """Scores for the bitpal-edit / bitpal-scored algorithms
    (benchmark_bitpal.c:30-52), batched by length; with a mesh each
    batch's rows split over its devices (`shard_args`)."""
    devs = mesh_devices(mesh, device)
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
        arrays = (pat, txt, plen, tlen)
        shards = (zip(*shard_args(mesh, *arrays)) if mesh is not None else
                  [[torch.from_numpy(a).to(devs[0]) for a in arrays]])
        scores = []
        for dev, args in zip(devs, shards):
            with device_scope(dev):
                scores.append(_bitpal_device(*args, L=L, m_sc=m_sc,
                                             x_sc=x_sc, g_sc=g_sc))
        out[chunk] = gather_shards(scores, B).numpy()
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
    mesh = data_mesh()
    pairs = read_seqpairs(args.input, swap_longer_first=True)
    roi = ROITimer("bpm", "=> Time.Benchmark      {t:.2f} s")
    with roi:
        if args.algorithm == "bitpal-edit":
            scores = bitpal_batch(pairs, 0, -1, -1, device=dev, mesh=mesh)
        elif args.algorithm == "bitpal-scored":
            scores = bitpal_batch(pairs, 1, -4, -2, device=dev, mesh=mesh)
        else:
            scores = bpm_batch(pairs, device=dev, mesh=mesh)
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
