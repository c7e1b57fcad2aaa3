"""kmer-cnt inputs for the port's tests and chip_smoke.py, numpy only
(no JAX, no JAX package)."""

import numpy as np

BENCH_K = 17


def gen_fasta(rng, path, n_reads=6, min_len=5200, max_len=9000):
    """tests/test_kmer.py::gen_fasta draw for draw: random reads of
    [min_len, max_len) bases, 80 a line."""
    with open(path, "w") as f:
        for i in range(n_reads):
            L = int(rng.integers(min_len, max_len))
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            f.write(f">read_{i}\n")
            for j in range(0, L, 80):
                f.write(s[j:j + 80] + "\n")


def bench_fasta(path, n_reads=120, read_len=20000):
    """bench.py:50-64's kmer-cnt reads (rng 4242: n_reads reads of
    read_len +- 2000 bases, `BENCH_KMER_READS` and `BENCH_KMER_READLEN`
    there); returns the bases written."""
    rng = np.random.default_rng(4242)
    total = 0
    with open(path, "w") as f:
        for i in range(n_reads):
            L = read_len + int(rng.integers(-2000, 2000))
            total += L
            f.write(f">read_{i}\n")
            s = "".join("ACGT"[c] for c in rng.integers(0, 4, L))
            for j in range(0, L, 80):
                f.write(s[j:j + 80] + "\n")
    return total


def write_config(path, k=BENCH_K, use_minimizers=0, window=None):
    """bench.py:65-67's config (kmer_size, use_minimizers,
    assemble_kmer_sample), with `minimizer_window` when given."""
    text = (f"kmer_size = {k}\nuse_minimizers = {use_minimizers}\n"
            "assemble_kmer_sample = 1\n")
    if window is not None:
        text += f"minimizer_window = {window}\n"
    path.write_text(text)
