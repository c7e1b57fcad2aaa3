"""dbg inputs for the port's tests and chip_smoke.py, numpy only (no
JAX, no JAX package): `make_case` is tests/test_dbg.py::make_case draw
for draw, with the BAM writer passed in (`bam_io`, either package's),
so that both packages' writers can be held to one another byte for
byte."""

import numpy as np

BENCH = dict(seed=108, ref_len=500_000, n_reads=25_000, read_len=150)
BENCH_REGION = "tig1:0-500000"


def make_case(tmp_path, rng, bam_io, ref_len=5000, n_reads=50, read_len=150,
              err=0.03, low_qual_frac=0.2):
    ref = "".join("ACGT"[c] for c in rng.integers(0, 4, ref_len))
    fa = tmp_path / "ref.fa"
    with open(fa, "w") as f:
        f.write(">tig1\n")
        for i in range(0, ref_len, 70):
            f.write(ref[i:i + 70] + "\n")
    # .fai index for the reference binary's faidx
    with open(str(fa) + ".fai", "w") as f:
        f.write(f"tig1\t{ref_len}\t6\t70\t71\n")
    records = []
    for i in range(n_reads):
        pos = int(rng.integers(0, ref_len - read_len))
        s = list(ref[pos:pos + read_len])
        for _ in range(int(read_len * err)):
            j = int(rng.integers(0, read_len))
            s[j] = "ACGTN"[rng.integers(0, 5)]
        qual = rng.integers(10, 40, read_len).astype(np.uint8)
        if rng.random() < low_qual_frac:
            qual[rng.integers(0, read_len)] = 5     # kills windows
        cig = [(0, read_len)]
        if rng.random() < 0.3:
            sc = int(rng.integers(1, 10))
            cig = [(4, sc), (0, read_len - sc)]
        flag = 16 if rng.random() < 0.5 else 0
        if rng.random() < 0.05:
            flag |= 0x200                           # QC fail
        records.append(bam_io.BamRecord(
            f"r{i}", flag, 0, pos, 40, cig,
            "".join(s), qual))
    records.sort(key=lambda r: r.pos)
    bam = tmp_path / "r.bam"
    bam_io.write_bam(str(bam), [("tig1", ref_len)], records)
    return bam, fa


def bench_case(out_dir, bam_io):
    """bench.py:132-139's dbg input: a 500 kb reference and 25,000 reads
    of 150 bases (rng 108); its region is BENCH_REGION."""
    kw = dict(BENCH)
    return make_case(out_dir, np.random.default_rng(kw.pop("seed")), bam_io,
                     **kw)
