"""Seed extensions as BWA-MEM2 hands them to its banded Smith-Waterman:
Illumina reads simulated as wgsim makes them, each seeded by its longest
exact match with the reference and extended from it to the left and to
the right.

For a traffic file's parameters (each named with its source in the
file), batch k of a seed holds `pairs` pairs, made so:

1. a reference of `contigs` uniform random bases, the same for every
   batch of the seed;
2. fragments of a normal length (`fragment_mean`, `fragment_sd`) from
   uniform places of the contigs, on either strand, each giving two
   reads of `read_length` bases from its two ends, as the `sr` traffic
   draws them (`generators/reads.py::_reads`); each read is taken on the
   fragment's strand, a mate's reverse complement being the same pair of
   sequences complemented and read backwards;
3. wgsim's mutations of the read's haplotype: each template base
   mutated with probability `mutation_rate` x 2/3 (a third of wgsim's
   mutations are on both haplotypes, the rest on one of the two), a
   fraction `indel_fraction` of them indels, else a substitution by
   another base; an indel is a deletion of the base and of each next one
   with probability `indel_extend`, or, as often, the base followed by
   1-4 inserted random bases, each after the first with probability
   `indel_extend`;
4. wgsim's sequencing errors: each read base substituted by another with
   probability `error_rate`;
5. the seed: the read's longest stretch of bases neither mutated, nor
   inserted, nor in error, that follow one another in the reference
   (the first such stretch of the longest length), and at least
   `min_seed_len` long; reads without one are dropped, as BWA-MEM finds
   no seed there;
6. the extensions, as BWA-MEM's mem_chain2aln makes them with `a`,
   `o_del`, `e_del`, `o_ins`, `e_ins` and `w`: to the left the read
   before the seed, reversed, against the reference before the seed,
   reversed; to the right the read after the seed against the reference
   after it; each target `qlen + cal_max_gap(qlen)` bases long, cut at
   its contig's end; each starting from h0, the seed's length x `a`.
   Extensions with an empty query are dropped, as BWA-MEM makes none.
   A read's left extension comes before its right one.

A record is one sort slice of `slice_pairs` consecutive pairs (the last
one may hold fewer): bsw's pipeline sorts each slice by reference length
into groups that share their band, so a pair's score depends on the rest
of its slice, and a slice is the smallest part of a batch whose answers
depend on nothing else.

Everything is drawn with NumPy from the seed and the batch's index, so
that the same seed gives the same batches on any host.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import numpy as np

from h100_bench.generators.pairs import _take
from h100_bench.generators.reads import _reads


@dataclasses.dataclass
class ExtensionBatch:
    """One batch of extension pairs as flat arrays: pair p's target is
    ref[r_offs[p]:r_offs[p + 1]], its query qry[q_offs[p]:q_offs[p + 1]],
    bases as codes 0-3 (4 for N), its start score h0[p].  Record s is
    the sort slice of n[s] consecutive pairs."""
    n: np.ndarray            # (S,) int64, pairs a slice
    h0: np.ndarray           # (P,) int32
    r_offs: np.ndarray       # (P + 1,) int64
    q_offs: np.ndarray       # (P + 1,) int64
    ref: np.ndarray          # uint8
    qry: np.ndarray          # uint8

    def __len__(self) -> int:
        return len(self.n)

    @property
    def pairs(self) -> int:
        return len(self.h0)

    def targets(self) -> List[np.ndarray]:
        o = self.r_offs.tolist()
        return [self.ref[a:b] for a, b in zip(o[:-1], o[1:])]

    def queries(self) -> List[np.ndarray]:
        o = self.q_offs.tolist()
        return [self.qry[a:b] for a, b in zip(o[:-1], o[1:])]

    def slice_offsets(self) -> np.ndarray:
        """(S + 1,): slice s holds pairs [offs[s], offs[s + 1])."""
        offs = np.zeros(len(self.n) + 1, np.int64)
        np.cumsum(self.n, out=offs[1:])
        return offs

    def subset(self, idx: np.ndarray) -> "ExtensionBatch":
        """The slices `idx`, in that order, as a batch of their own."""
        idx = np.asarray(idx, np.int64)
        s_offs = self.slice_offsets()
        pairs = np.concatenate([np.arange(s_offs[s], s_offs[s + 1])
                                for s in idx.tolist()] + [np.zeros(0, int)])
        r_offs, ref = _take(self.r_offs, self.ref, pairs)
        q_offs, qry = _take(self.q_offs, self.qry, pairs)
        return ExtensionBatch(self.n[idx], self.h0[pairs], r_offs, q_offs,
                              ref, qry)


def cal_max_gap(t: dict, qlen: np.ndarray) -> np.ndarray:
    """BWA-MEM's cal_max_gap: the longest gap the extension of a query of
    `qlen` bases can hold, by the deletion and insertion costs (C's
    truncation of a double), at least 1 and at most 2w."""
    q = np.asarray(qlen, np.float64) * t["a"]
    l_del = np.trunc((q - t["o_del"]) / t["e_del"] + 1.0)
    l_ins = np.trunc((q - t["o_ins"]) / t["e_ins"] + 1.0)
    return np.minimum(np.maximum(np.maximum(l_del, l_ins), 1),
                      2 * t["w"]).astype(np.int64)


def _genome(t: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed % (1 << 64), 1 << 40])
    return rng.integers(0, 4, int(sum(t["contigs"])), dtype=np.uint8)


def _ragged(lens: np.ndarray):
    """(each element's row, its index in the row) of rows of `lens`."""
    rows = np.repeat(np.arange(len(lens)), lens)
    first = np.cumsum(lens) - lens
    return rows, np.arange(int(lens.sum())) - first[rows]


def _mutate(rng, t: dict, tmpl: np.ndarray):
    """The haplotype of each row of template bases `tmpl` (R, T): (its
    bases flat, each base's row, template index (-1 inserted) and 1 where
    it is a reference base left as it was)."""
    R, T = tmpl.shape
    ext = float(t["indel_extend"])
    mut = np.flatnonzero(rng.random(R * T)
                         < float(t["mutation_rate"]) * 2 / 3)
    indel = rng.random(len(mut)) < float(t["indel_fraction"])
    dele = indel & (rng.random(len(mut)) < 0.5)
    sub = np.zeros(R * T, bool)
    sub[mut[~indel]] = True
    base = tmpl.ravel().copy()
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    # a deletion takes its base and each next one with probability ext
    reach = np.zeros(R * T, np.int64)
    reach[mut[dele]] = mut[dele] % T + rng.geometric(1 - ext, int(dele.sum()))
    deleted = (np.arange(T) < np.maximum.accumulate(
        reach.reshape(R, T), axis=1)).ravel()
    emit = np.where(deleted, 0, 1).astype(np.int64)
    ins = mut[indel & ~dele]
    ins = ins[~deleted[ins]]
    emit[ins] += np.minimum(rng.geometric(1 - ext, len(ins)), 4)
    rows, k = _ragged(emit)
    first = k == 0
    out = base[rows]
    out[~first] = rng.integers(0, 4, int((~first).sum()), dtype=np.uint8)
    row, col = np.divmod(rows, T)
    return (out.astype(np.uint8), row, np.where(first, col, -1),
            first & ~sub[rows])


def _reads_of(rng, t: dict, genome: np.ndarray, count: int):
    """`count` fragments' reads: (reads (N, L), template index (N, L),
    clean (N, L), and per read the genome position of template index 0,
    its direction (+1 or -1, the reverse strand complemented) and its
    contig's bounds)."""
    L = int(t["read_length"])
    lens = np.asarray(t["contigs"], np.int64)
    starts = np.cumsum(lens) - lens
    start, strand, contig, frag, seg_q, seg_off, _ = _reads(rng, dict(
        pairs=True, batch_bases=2 * L * count, read_length=L,
        fragment_mean=t["fragment_mean"], fragment_sd=t["fragment_sd"]),
        lens)
    rev = strand[seg_q] == 1
    lo, hi = starts[contig[seg_q]], starts[contig[seg_q]] + lens[contig[seg_q]]
    fwd0 = lo + start[seg_q]
    origin = np.where(rev, fwd0 + frag[seg_q] - 1 - seg_off, fwd0 + seg_off)
    step = np.where(rev, -1, 1)
    T = L + int(t["template_margin"])
    g = np.clip(origin[:, None] + step[:, None] * np.arange(T), lo[:, None],
                hi[:, None] - 1)
    tmpl = np.where(rev[:, None], 3 - genome[g], genome[g]).astype(np.uint8)
    hap, row, tidx, clean = _mutate(rng, t, tmpl)
    # the first L bases of each haplotype are the read
    k = _ragged(np.bincount(row, minlength=len(tmpl)))[1]
    keep = k < L
    full = np.bincount(row[keep], minlength=len(tmpl)) == L
    reads = np.zeros((len(tmpl), L), np.uint8)
    tix = np.full((len(tmpl), L), -1, np.int64)
    cln = np.zeros((len(tmpl), L), bool)
    reads[row[keep], k[keep]] = hap[keep]
    tix[row[keep], k[keep]] = tidx[keep]
    cln[row[keep], k[keep]] = clean[keep]
    err = rng.random(reads.shape) < float(t["error_rate"])
    reads = np.where(err, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    cln &= ~err
    return (reads[full], tix[full], cln[full], origin[full], step[full],
            lo[full], hi[full])


def _seeds(tix: np.ndarray, clean: np.ndarray):
    """Per read, the first of its longest clean stretches of consecutive
    template bases: (query start, query end, template start)."""
    N, L = tix.shape
    j = np.arange(L)
    cont = np.zeros_like(clean)
    cont[:, 1:] = clean[:, 1:] & clean[:, :-1] & (tix[:, 1:] == tix[:, :-1] + 1)
    begins = clean & ~cont
    last = np.maximum.accumulate(np.where(begins, j, -1), axis=1)
    run = np.where(clean, j - last + 1, 0)
    qe = run.argmax(axis=1) + 1
    length = run.max(axis=1)
    qs = qe - length
    return qs, qe, tix[np.arange(N), np.minimum(qs, L - 1)]


def _targets(genome, origin, step, lo, hi, first, sign, want):
    """Reference bases from template index `first` on, `sign` (+1 or -1)
    a base in template index, `want` of them a pair, cut where the contig
    ends: (flat bases, the lengths)."""
    rows, k = _ragged(want)
    g = origin[rows] + step[rows] * (first[rows] + sign[rows] * k)
    ok = (g >= lo[rows]) & (g < hi[rows])
    # g is monotone along a row: the bases in the contig are a prefix
    lens = np.bincount(rows[ok], minlength=len(want))
    g, rows = g[ok], rows[ok]
    bases = genome[g]
    return np.where(step[rows] < 0, 3 - bases, bases).astype(np.uint8), lens


def _round(rng, t: dict, genome: np.ndarray, count: int):
    """The extension pairs of `count` fragments' reads, in read order:
    (h0, target lengths, targets flat, query lengths, queries flat)."""
    reads, tix, clean, origin, step, lo, hi = _reads_of(rng, t, genome,
                                                        count)
    qs, qe, rs = _seeds(tix, clean)
    L = reads.shape[1]
    seeded = (qe - qs) >= int(t["min_seed_len"])
    reads, origin, step, lo, hi, qs, qe, rs = (
        a[seeded] for a in (reads, origin, step, lo, hi, qs, qe, rs))
    re = rs + (qe - qs)
    # pair 2r is read r's left extension, 2r + 1 its right one
    qlen = np.stack([qs, L - qe], 1).ravel()
    who = np.repeat(np.arange(len(qs)), 2)
    side = np.tile([-1, 1], len(qs))
    h0 = np.repeat((qe - qs) * int(t["a"]), 2)
    first = np.where(side < 0, np.repeat(rs, 2) - 1, np.repeat(re, 2))
    keep = qlen > 0
    who, side, first, qlen, h0 = (a[keep] for a in (who, side, first, qlen,
                                                    h0))
    tgt, tlen = _targets(genome, origin[who], step[who], lo[who], hi[who],
                         first, side, qlen + cal_max_gap(t, qlen))
    rows, k = _ragged(qlen)
    q0 = np.where(side < 0, np.repeat(qs, 2)[keep] - 1,
                  np.repeat(qe, 2)[keep])
    qry = reads[who[rows], q0[rows] + side[rows] * k]
    return h0, tlen, tgt, qlen, qry


def _batch(t: dict, seed: int, k: int, genome: np.ndarray) -> ExtensionBatch:
    P = int(t["pairs"])
    # about 1.4 extensions a read (the seed begins or ends 3 reads in
    # 10), two reads a fragment
    count = P * 2 // 5 + 64
    parts, got, r = [], 0, 0
    while got < P:
        rng = np.random.default_rng([seed % (1 << 64), k, r])
        parts.append(_round(rng, t, genome, count))
        if not len(parts[-1][0]):
            raise ValueError("no read of this traffic leaves an extension")
        got += len(parts[-1][0])
        r += 1
    h0, tlen, tgt, qlen, qry = (np.concatenate(a) for a in zip(*parts))
    r_offs = np.zeros(len(tlen) + 1, np.int64)
    q_offs = np.zeros(len(qlen) + 1, np.int64)
    np.cumsum(tlen, out=r_offs[1:])
    np.cumsum(qlen, out=q_offs[1:])
    S = int(t["slice_pairs"])
    n = np.diff(np.append(np.arange(0, P, S), P)).astype(np.int64)
    return ExtensionBatch(n, h0[:P].astype(np.int32), r_offs[:P + 1],
                          q_offs[:P + 1], tgt[:r_offs[P]], qry[:q_offs[P]])


def batches(traffic: dict, seed: int, ks: Iterable[int],
            device="cpu") -> List[ExtensionBatch]:
    """Batches `ks` of the traffic for `seed`, host arrays on any
    `device`: the program copies them to its card itself."""
    genome = _genome(traffic, seed)
    return [_batch(traffic, seed, int(k), genome) for k in ks]
