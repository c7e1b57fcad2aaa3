"""Seeded reads seeded against a seeded reference as minimap2 seeds them:
each record is the anchor list that minimap2's chain_dp gets for one
read, or for one read pair in fragment mode.

For a traffic file's parameters (each named with its source in the
file), batch k of a seed is made so:

1. a reference of `contigs` uniform random bases, the same for every
   batch of the seed;
2. reads until `batch_bases` query bases: single reads of a gamma length
   (`length_mean`, `length_sd`), or pairs of `read_length` bases from
   the two ends of a normal fragment (`fragment_mean`, `fragment_sd`),
   the second mate reverse-complemented back onto the fragment's strand
   as minimap2 does for FR pairs; each from a uniform position of a
   contig drawn by length, on either strand;
3. sequencing errors at a per-read rate: 1 - an identity drawn from a
   beta scaled to its maximum (`identity`: mean, max, sd), or a fixed
   `error_rate`; each error a substitution, an insertion or a deletion
   in the shares `error_shares`;
4. minimizers of the reference and of every read (each mate apart) at
   the preset's `k` and `w`: canonical k-mers hashed by minimap2's
   hash64, the smallest of each window of w consecutive k-mers;
5. anchors: each read minimizer against every reference minimizer of
   the same hash, x and y as minimap2's collect_seed_hits makes them
   (the query position of a hit on the reverse strand counted from the
   query's end), sorted by x;
6. the header as mm_map_frag hands it to chain_dp: max_dist_x the
   larger of max_frag_len - qlen (when max_frag_len is set) and
   max_gap, max_dist_y the larger of qlen and max_gap, bw, n_segs, and
   avg_qspan the mean q_span, k.  Reads with no anchor are dropped:
   minimap2 chains none.

The per-read draws (lengths, places, strands, identities) are NumPy's;
the per-base work (the bases and their errors, k-mers, hashes,
minimizers and the matching) runs in torch on the given device, in a
few large calls, from a torch.Generator.  Both are seeded from the seed
and the batch's index: the same seed on the same kind of device gives
the same batches.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from h100_bench.generators.batch import AnchorBatch

I64 = torch.int64
TOP = torch.iinfo(torch.int64).min     # bit 63


def _seed(seed: int, *stream: int) -> int:
    return int(np.random.SeedSequence(
        [seed % (1 << 64), *stream]).generate_state(1, np.uint64)[0])


def _back(a: torch.Tensor, m: int) -> torch.Tensor:
    """a shifted m places later: out[i] = a[i - m], 0 before."""
    out = torch.zeros_like(a)
    out[m:] = a[:len(a) - m]
    return out


def kmer_codes(b: torch.Tensor, k: int):
    """(forward, reverse-complement) 2-bit codes of the k-mer ending at
    each base of `b` (codes 0-3, A C G T), the last base lowest in the
    forward code and, complemented, highest in the reverse one.  Built
    by doubling; garbage for the first k - 1 positions."""
    pf, pr, p = b.to(I64), (3 - b.to(I64)), 1
    F = R = None
    m, kk = 0, k
    while kk:
        if kk & 1:
            if F is None:
                F, R = pf, pr
            else:       # p more bases before the last m
                F = (_back(pf, m) << (2 * m)) | F
                R = (R << (2 * p)) | _back(pr, m)
            m += p
        kk >>= 1
        if kk:
            pf = (_back(pf, p) << (2 * p)) | pf
            pr = (pr << (2 * p)) | _back(pr, p)
            p *= 2
    return F, R


def hash64(key: torch.Tensor, k: int) -> torch.Tensor:
    """minimap2's invertible integer hash (sketch.c) over 2k bits, in
    int64 (2k <= 62; a product that passes bit 63 wraps, and only its
    low 2k bits are kept)."""
    mask = (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def _sliding(a: torch.Tensor, w: int, op) -> torch.Tensor:
    """op over a[i:i + w] for i = 0 .. len(a) - w (a sparse table of
    two overlapping power-of-two blocks)."""
    p, blk = 1, a
    while 2 * p <= w:
        blk = op(blk[:len(blk) - p], blk[p:])
        p *= 2
    return op(blk[:len(a) - w + 1], blk[w - p:w - p + len(a) - w + 1])


def minimizers(b: torch.Tensor, seg: torch.Tensor, local: torch.Tensor,
               k: int, w: int):
    """Minimizers of the sequences laid end to end in `b` (seg: each
    base's sequence, local: its index there): (positions of each
    minimizer's last base in b, their hashes, their strands, 1 where the
    reverse complement is the smaller).  A window is w consecutive
    k-mers of one sequence; a k-mer is a minimizer when it is the
    smallest of some window (all of a tie)."""
    n = len(b)
    if n < k + w - 1:
        e = torch.zeros(0, dtype=I64, device=b.device)
        return e, e, e
    fwd, rev = kmer_codes(b, k)
    z = (fwd > rev).to(I64)                  # odd k: never equal
    h = hash64(torch.minimum(fwd, rev), k)
    del fwd, rev
    ok = (local[:n - w + 1] >= k - 1) & (seg[:n - w + 1] == seg[w - 1:])
    wmin = torch.full((n + w - 1,), -1, dtype=I64, device=b.device)
    wmin[w - 1:n] = torch.where(
        ok, _sliding(h, w, torch.minimum), -1)
    # a k-mer is the minimum of a window it is in iff it equals the
    # largest of those windows' minima
    top = _sliding(wmin, w, torch.maximum)
    del wmin
    pos = torch.nonzero((h == top) & (local >= k - 1)).flatten()
    return pos, h[pos], z[pos]


def _seg_arange(lengths: torch.Tensor) -> torch.Tensor:
    """0 .. l - 1 for each l of `lengths`, laid end to end."""
    starts = torch.cumsum(lengths, 0) - lengths
    return torch.arange(int(lengths.sum()), dtype=I64,
                        device=lengths.device) - torch.repeat_interleave(
        starts, lengths)


def _error_rates(rng, t: dict, count: int) -> np.ndarray:
    """Per read, 1 - its identity."""
    if "identity" in t:
        mean, top, sd = (t["identity"][key] for key in ("mean", "max", "sd"))
        m, s = mean / top, sd / top
        c = m * (1 - m) / (s * s) - 1
        return 1.0 - top * rng.beta(m * c, (1 - m) * c, size=count)
    return np.full(count, float(t["error_rate"]))


def _sequence(g, tmpl: torch.Tensor, seg_of: torch.Tensor,
              rate: torch.Tensor, shares: dict):
    """The template bases with errors at each segment's rate: (bases,
    each base's segment)."""
    total = sum(shares.values())
    e = rate[seg_of]
    p_del = e * (shares.get("del", 0) / total)
    p_sub = p_del + e * (shares.get("sub", 0) / total)
    p_ins = p_sub + e * (shares.get("ins", 0) / total)
    dev = tmpl.device
    u = torch.rand(len(tmpl), generator=g, device=dev, dtype=torch.float64)
    other = (tmpl + torch.randint(1, 4, (len(tmpl),), generator=g,
                                  device=dev)) % 4
    base = torch.where((u >= p_del) & (u < p_sub), other, tmpl)
    ins = (u >= p_sub) & (u < p_ins)
    count = torch.where(u < p_del, 0, 1 + ins.to(I64))
    out = torch.repeat_interleave(base, count)
    first = torch.cumsum(count, 0) - count
    extra = first[ins] + 1
    out[extra] = torch.randint(0, 4, (len(extra),), generator=g,
                               device=dev)
    return out, torch.repeat_interleave(seg_of, count)


def _index(t: dict, seed: int, dev: torch.device):
    """The seed's reference and its minimizers, sorted by hash: (bases,
    and per minimizer its hash, strand, contig and position)."""
    g = torch.Generator(device=dev)
    g.manual_seed(_seed(seed, 1 << 40))
    lens = torch.tensor(t["contigs"], dtype=I64, device=dev)
    b = torch.randint(0, 4, (int(lens.sum()),), generator=g, device=dev,
                      dtype=I64)
    seg = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
    local = _seg_arange(lens)
    pos, h, z = minimizers(b, seg, local, int(t["k"]), int(t["w"]))
    h, order = torch.sort(h, stable=True)
    pos = pos[order]
    return b, h, z[order], seg[pos], local[pos]


def _reads(rng, t: dict, lens: np.ndarray):
    """Queries of at least `batch_bases` bases: (per query its template
    start, strand, contig and fragment length; per segment its query,
    offset in the fragment and length)."""
    pairs = bool(t["pairs"])
    est = int(t["batch_bases"] / (2 * t["read_length"] if pairs
                                  else t["length_mean"]) * 1.3) + 16
    if pairs:
        frag = np.rint(rng.normal(t["fragment_mean"], t["fragment_sd"],
                                  est)).astype(np.int64)
        frag = np.clip(frag, t["read_length"], int(lens.min()))
        qlen = np.full(est, 2 * t["read_length"], np.int64)
    else:
        shape = (t["length_mean"] / t["length_sd"]) ** 2
        scale = t["length_sd"] ** 2 / t["length_mean"]
        frag = np.clip(np.rint(rng.gamma(shape, scale, est)).astype(
            np.int64), 1, int(lens.min()))
        qlen = frag
    q = int(np.searchsorted(np.cumsum(qlen), t["batch_bases"])) + 1
    if q > est:
        raise ValueError("batch_bases beyond the reads drawn")
    frag = frag[:q]
    contig = rng.choice(len(lens), size=q, p=lens / lens.sum())
    start = (rng.random(q) * (lens[contig] - frag + 1)).astype(np.int64)
    strand = rng.integers(0, 2, size=q)
    if pairs:
        r = int(t["read_length"])
        seg_q = np.repeat(np.arange(q), 2)
        seg_off = np.stack([np.zeros(q, np.int64), frag - r], 1).ravel()
        seg_len = np.full(2 * q, r, np.int64)
    else:
        seg_q, seg_off, seg_len = np.arange(q), np.zeros(q, np.int64), frag
    return start, strand, contig, frag, seg_q, seg_off, seg_len


def _batch(t: dict, seed: int, k: int, index, dev: torch.device
           ) -> AnchorBatch:
    K, W = int(t["k"]), int(t["w"])
    ref, rh, rz, rid, rloc = index
    lens = np.asarray(t["contigs"], np.int64)
    rng = np.random.default_rng([seed % (1 << 64), k])
    start, strand, contig, frag, seg_q, seg_off, seg_len = (
        torch.from_numpy(np.asarray(a, np.int64)).to(dev)
        for a in _reads(rng, t, lens))
    rate = torch.from_numpy(_error_rates(rng, t, len(start))).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(_seed(seed, k, 1 << 41))
    offs_c = torch.from_numpy(np.cumsum(lens) - lens).to(dev)

    # template bases of every segment, on the fragment's strand
    nseg = len(seg_q)
    seg_of = torch.repeat_interleave(torch.arange(nseg, device=dev),
                                     seg_len)
    i = _seg_arange(seg_len) + torch.repeat_interleave(seg_off, seg_len)
    fq = seg_q[seg_of]
    fwd_at = offs_c[contig[fq]] + start[fq]
    rev = strand[fq] == 1
    at = torch.where(rev, fwd_at + frag[fq] - 1 - i, fwd_at + i)
    tmpl = torch.where(rev, 3 - ref[at], ref[at])
    del i, fq, fwd_at, rev, at
    bases, seg = _sequence(g, tmpl, seg_of, rate[seg_q], t["error_shares"])
    del tmpl, seg_of
    out_len = torch.bincount(seg, minlength=nseg)
    local = _seg_arange(out_len)
    pos, h, z = minimizers(bases, seg, local, K, W)
    del bases

    # query coordinates: the mates laid end to end
    nq = len(start)
    qlen = torch.zeros(nq, dtype=I64, device=dev).index_add_(0, seg_q,
                                                             out_len)
    seg_first = torch.cumsum(out_len, 0) - out_len
    q_first = torch.cumsum(qlen, 0) - qlen
    q_seg0 = torch.searchsorted(seg_q, torch.arange(nq, device=dev))
    mseg = seg[pos]
    mq = seg_q[mseg]
    qpos = local[pos] + seg_first[mseg] - q_first[mq]
    sid = mseg - q_seg0[mq]
    del seg, local, pos

    lo = torch.searchsorted(rh, h)
    cnt = torch.searchsorted(rh, h, right=True) - lo
    src = torch.repeat_interleave(torch.arange(len(h), device=dev), cnt)
    hit = torch.repeat_interleave(lo, cnt) + _seg_arange(cnt)
    same = z[src] == rz[hit]
    aq = mq[src]
    qp = qpos[src]
    qp = torch.where(same, qp, qlen[aq] - (qp + 1 - K) - 1)
    x = torch.where(same, 0, TOP) | (rid[hit] << 32) | rloc[hit]
    y = (sid[src] << 48) | (K << 32) | qp
    # by query, then by x as an unsigned number, ties in seeding order
    o = torch.sort(x ^ TOP, stable=True)[1]
    o = o[torch.sort(aq[o], stable=True)[1]]
    x = x[o].cpu().numpy().view(np.uint64)
    y = y[o].cpu().numpy().view(np.uint64)

    n_all = torch.bincount(aq, minlength=nq).cpu().numpy()
    keep = n_all > 0
    n = n_all[keep].astype(np.int64)
    offs = np.zeros(len(n) + 1, np.int64)
    np.cumsum(n, out=offs[1:])
    ql = qlen.cpu().numpy()[keep]
    gap = int(t["max_gap"])
    frag_len = int(t["max_frag_len"])
    mdx = (np.maximum(frag_len - ql, gap) if frag_len > 0
           else np.full(len(n), gap, np.int64))
    mdy = np.maximum(ql, gap)
    segs = 2 if t["pairs"] else 1
    return AnchorBatch(n, offs, np.full(len(n), K, np.float32), mdx, mdy,
                       np.full(len(n), int(t["bw"]), np.int64),
                       np.full(len(n), segs, np.int64), x, y)


def batches(traffic: dict, seed: int, ks: Iterable[int],
            device="cpu") -> List[AnchorBatch]:
    """Batches `ks` of the traffic for `seed`, made on `device`: the same
    seed and k give the same batch."""
    dev = torch.device(device)
    index = _index(traffic, seed, dev)
    return [_batch(traffic, seed, int(k), index, dev) for k in ks]
