"""Inputs for the fmi port's tests and chip_smoke.py, numpy only.

`gen_case` is tests/test_fmi.py's generator; `bench_input` writes the
JAX bench's fmi input (bench.py:108-122) byte for byte; `tandem_case`
writes a reference with tandem repeats, whose reads push SMEM searches
into the wide prev-list tiers, and reads with no SMEM at the end.
"""

import numpy as np

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def write_fasta(path, ref: str) -> None:
    with open(path, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(ref), 70):
            f.write(ref[i:i + 70] + "\n")


def gen_case(tmp_path, rng, ref_len=20000, n_reads=24, read_len=100,
             err=0.05, with_n=False):
    ref = "".join("ACGT"[c] for c in rng.integers(0, 4, ref_len))
    fa = tmp_path / "ref.fa"
    write_fasta(fa, ref)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i in range(n_reads):
            p = int(rng.integers(0, ref_len - read_len))
            s = list(ref[p:p + read_len])
            nmut = int(read_len * err)
            for _ in range(nmut):
                j = int(rng.integers(0, read_len))
                s[j] = "ACGT"[rng.integers(0, 4)]
            if with_n and rng.random() < 0.5:
                s[int(rng.integers(0, read_len))] = "N"
            if rng.random() < 0.3:   # reverse complement read
                s = [COMP[c] for c in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * read_len}\n")
    return fa, fq


def bench_input(out_dir, n_reads=250_000, ref_len=2_000_000, read_len=100,
                seed=106):
    """bench.py's fmi input: a random reference and reads of read_len
    bases with 5 substitutions each, written as out_dir/ref.fa and
    out_dir/reads.fq."""
    rng_f = np.random.default_rng(seed)
    fa, fq = out_dir / "ref.fa", out_dir / "reads.fq"
    ref = "".join("ACGT"[c] for c in rng_f.integers(0, 4, ref_len))
    write_fasta(fa, ref)
    with open(fq, "w") as f:
        for i in range(n_reads):
            p = int(rng_f.integers(0, ref_len - read_len))
            s = list(ref[p:p + read_len])
            for _ in range(5):
                s[int(rng_f.integers(0, read_len))] = \
                    "ACGT"[rng_f.integers(0, 4)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * read_len}\n")
    return fa, fq


# (unit, copies): a homopolymer run fills a 100-base read's prev list
# past 64 entries (the full tier), the 2- and 3-base units past 16
REPEATS = [("A", 1500), ("AC", 700), ("AGT", 400), ("ACGTT", 120)]


def tandem_case(tmp_path, rng, ref_len=20000, n_reads=24, read_len=100,
                n_empty=2):
    """A reference of random stretches around the REPEATS, padded to
    ref_len bases; reads from inside each repeat (some with one
    substitution), across its edges and from the random stretches, then
    n_empty reads of N alone, which have no SMEM."""
    rep = [u * c for u, c in REPEATS]
    gap = (ref_len - sum(len(r) for r in rep)) // (len(rep) + 1)
    parts, starts = [], []
    for r in rep:
        parts.append("".join("ACGT"[c] for c in rng.integers(0, 4, gap)))
        starts.append(sum(len(p) for p in parts))
        parts.append(r)
    tail = ref_len - sum(len(p) for p in parts)
    parts.append("".join("ACGT"[c] for c in rng.integers(0, 4, tail)))
    ref = "".join(parts)
    fa = tmp_path / "ref.fa"
    write_fasta(fa, ref)
    fq = tmp_path / "reads.fq"
    with open(fq, "w") as f:
        for i in range(n_reads - n_empty):
            k = i % (len(rep) + 1)
            if k < len(rep):
                lo = starts[k] + (-read_len // 2 if i % 3 == 2 else 0)
                p = lo + int(rng.integers(0, len(rep[k]) - read_len))
            else:
                p = int(rng.integers(0, ref_len - read_len))
            s = list(ref[p:p + read_len])
            if i % 2:
                s[int(rng.integers(0, read_len))] = "ACGT"[rng.integers(0, 4)]
            if i % 5 == 4:
                s = [COMP[c] for c in reversed(s)]
            f.write(f"@r{i}\n{''.join(s)}\n+\n{'I' * read_len}\n")
        for i in range(n_reads - n_empty, n_reads):
            f.write(f"@r{i}\n{'N' * read_len}\n+\n{'I' * read_len}\n")
    return fa, fq


def smem_lines(text):
    return [ln for ln in text.splitlines()
            if ln.endswith(":") and ln[:-1].isdigit() or ln.startswith("[")]
