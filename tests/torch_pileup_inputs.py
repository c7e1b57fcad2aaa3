"""pileup inputs for the port's tests and chip_smoke.py, numpy only (no
JAX, no JAX package): `make_bam` is tests/test_pileup.py::make_bam draw
for draw, with the BAM writer passed in (`bam_io`, either package's),
so that both packages' writers can be held to one another byte for
byte."""

import numpy as np

BENCH = dict(seed=107, ref_len=500_000, n_reads=60_000, read_len=300)
BENCH_REGION = "tig1:1-500000"


def make_bam(path, rng, bam_io, ref_len=2000, n_reads=40, with_indels=True,
             read_len=160):
    refs = [("tig1", ref_len), ("tig2", ref_len)]
    records = []
    for i in range(n_reads):
        pos = int(rng.integers(0, ref_len - read_len))
        flag = 16 if rng.random() < 0.5 else 0
        if rng.random() < 0.05:
            flag |= 0x100                        # secondary: filtered
        cig = []
        remaining = read_len
        qlen = 0
        if rng.random() < 0.3:
            s = int(rng.integers(1, 8))
            cig.append((4, s))                   # soft clip
            qlen += s
        while remaining > 0:
            m = int(rng.integers(min(5, remaining), remaining + 1))
            cig.append((0, m))
            qlen += m
            remaining -= m
            if remaining > 2 and with_indels:
                r = rng.random()
                if r < 0.35:
                    ln = int(rng.integers(1, 4))
                    cig.append((1, ln))          # insertion
                    qlen += ln
                elif r < 0.6:
                    ln = int(rng.integers(1, 4))
                    cig.append((2, min(ln, remaining)))  # deletion
                    remaining -= min(ln, remaining)
                elif r < 0.68:
                    ln = int(rng.integers(2, 6))
                    cig.append((3, min(ln, remaining)))  # refskip
                    remaining -= min(ln, remaining)
        seq = "".join("ACGTN"[c] for c in
                      rng.choice(5, size=qlen, p=[.24, .24, .24, .24, .04]))
        qual = rng.integers(0, 40, qlen).astype(np.uint8)
        mapq = int(rng.integers(0, 50))
        records.append(bam_io.BamRecord(
            f"read{i}", flag, int(rng.integers(0, 2)), pos, mapq,
            cig, seq, qual))
    records.sort(key=lambda r: (r.ref_id, r.pos))
    bam_io.write_bam(str(path), refs, records)
    return refs, records


def bench_bam(path, bam_io):
    """bench.py:125-130's pileup input: 60,000 reads of 300 bases over a
    500 kb contig (rng 107); its region is BENCH_REGION."""
    kw = dict(BENCH)
    return make_bam(path, np.random.default_rng(kw.pop("seed")), bam_io,
                    **kw)


def single_contig_bam(path, rng, bam_io, ref_len, n_reads, read_len,
                      pos_lo=0, pos_span=None):
    """tests/test_pileup.py:145-175's shapes: one contig `big`, reads of
    one M run, forward and reverse in turn, at mapq 30, placed in
    [pos_lo, pos_lo + pos_span) (default: anywhere they fit)."""
    records = []
    for i in range(n_reads):
        pos = (pos_lo + int(rng.integers(0, pos_span)) if pos_span
               else int(rng.integers(0, ref_len - read_len)))
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, read_len))
        records.append(bam_io.BamRecord(
            f"r{i}", 0 if i % 2 else 16, 0, pos, 30, [(0, read_len)], seq,
            rng.integers(0, 40, read_len).astype(np.uint8)))
    records.sort(key=lambda r: r.pos)
    bam_io.write_bam(str(path), [("big", ref_len)], records)
