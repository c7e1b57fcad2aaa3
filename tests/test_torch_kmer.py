"""The port's kmer-cnt path against the JAX package, on the CPU, all
exact: the canonical codes (JAX's (hi, lo) pairs packed by
`convert.kmer_codes_from_jax`) at k = 5, 11, 17 and 22, where JAX's pair
codes are exact; the counts of `count_distinct` and
`count_distinct_hostmerge` and `cli run kmer-cnt`'s `Total k-mers` line
(random reads, a poly-A read of more than 256 copies of one k-mer, reads
with N), and above k = 22 the Python oracle
`tests/test_kmer.py::py_distinct`; the minimizers with the C deque
against its Python twin and JAX; the C FASTA reader against its plain
version and JAX's reader; the config reader; the bench generator
against bench.py's own source."""

import ast
import gzip
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from genarchbench_tpu.core import config as JC
from genarchbench_tpu.io import fasta_io as JF
from genarchbench_tpu.kernels import kmer as J
from genarchbench_tpu_torch import cli, convert, native
from genarchbench_tpu_torch.core.config import load_kv_config
from genarchbench_tpu_torch.io import fasta_io as TF
from genarchbench_tpu_torch.kernels import kmer as T
from tests import torch_kmer_inputs as I
from tests.test_kmer import py_distinct

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def write_reads(path, seqs, width=80):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">read_{i} some description\n")
            for j in range(0, len(s), width):
                f.write(s[j:j + width] + "\n")


def random_seq(rng, n, alphabet="ACGT"):
    return "".join(alphabet[c] for c in rng.integers(0, len(alphabet), n))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """FASTA files by name: random reads over the default --min-ovlp,
    one with a poly-A read (one k-mer seen thousands of times: the
    256-wrap replication), one with N in the reads (N counts as T)."""
    d = tmp_path_factory.mktemp("kmer")
    rng = np.random.default_rng(5)
    out = {"random": d / "random.fa", "poly-A": d / "polya.fa",
           "with-N": d / "n.fa"}
    I.gen_fasta(rng, out["random"], n_reads=3)
    write_reads(out["poly-A"], ["A" * 6000, random_seq(rng, 5400),
                                "ACGTT" * 1100])
    write_reads(out["with-N"], [random_seq(rng, 5300, "ACGTN"),
                                "N" * 5100 + random_seq(rng, 300),
                                random_seq(rng, 5600, "ACGTNacgtn")])
    return out


@pytest.mark.parametrize("k", [5, 11, 17, 22])
def test_codes_device_against_jax(k):
    rng = np.random.default_rng(k)
    lens = np.array([0, k - 1, k, k + 1, 300, 1000, 1024], np.int32)
    arr = np.zeros((len(lens), 1024), np.int32)
    for i, n in enumerate(lens):
        arr[i, :n] = rng.integers(0, 4, n)
    hi, lo = J._codes_device(arr, lens, k=k)
    want = convert.kmer_codes_from_jax(np.asarray(hi), np.asarray(lo))
    got = T._codes_device(torch.from_numpy(arr.astype(np.uint8)),
                          torch.from_numpy(lens), k)
    assert got.dtype == torch.int64 and got.shape == (len(lens), 1024 - k)
    assert torch.equal(got, want[:, :1024 - k])
    assert bool((want[:, 1024 - k:] == T.SENTINEL).all())
    assert int((got < T.SENTINEL).sum()) == int(np.maximum(lens - k, 0).sum())


@pytest.mark.parametrize("case", ["random", "poly-A", "with-N"])
@pytest.mark.parametrize("k", [11, 17])
def test_counts_against_jax(cases, case, k):
    reads = TF.read_fasta(str(cases[case]))
    jreads = JF.read_fasta(str(cases[case]))
    assert T.count_distinct(reads, k, device="cpu") == \
        J.count_distinct(jreads, k)
    assert T.count_distinct_hostmerge(reads, k, device="cpu") == \
        J.count_distinct_hostmerge(jreads, k)


def test_wrap_replication():
    """A k-mer seen c times counts ceil(c / 256) times; the plain
    distinct count (hostmerge) counts it once."""
    reads = TF.ReadSet(["a"], [np.zeros(6000, np.uint8)])
    assert T.count_distinct(reads, 11, device="cpu") == -(-5989 // 256)
    assert T.count_distinct_hostmerge(reads, 11, device="cpu") == 1


def test_small_batches_and_buckets():
    """Reads of several padded lengths in batches of 8 rows: one code
    tensor over all batches, the count unchanged."""
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, n).astype(np.uint8)
            for n in (100, 2047, 2049, 5000, 30, 4100) * 3]
    reads = TF.ReadSet([str(i) for i in range(len(seqs))], seqs)
    stats = {}
    got = T.count_distinct(reads, 13, batch_bases=1 << 12, device="cpu",
                           stats=stats)
    assert got == J.count_distinct(JF.ReadSet(reads.names, seqs), 13)
    assert stats["batches"] == 4
    assert set(stats) >= {"pack_s", "h2d_s", "codes_s", "count_s", "codes"}


@pytest.mark.parametrize("k", [23, 25, 31])
def test_large_k_against_python(k):
    """JAX's pair codes are exact only to k = 22 (its hi reaches
    HI_SENTINEL); the port's int64 codes hold 31 bases."""
    rng = np.random.default_rng(k)
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in (300, 41, 500)]
    seqs.append(np.tile(np.array([0, 1, 2, 3], np.uint8), 100))
    reads = TF.ReadSet(["a", "b", "c", "d"], seqs)
    want = py_distinct(reads, k)
    assert T.count_distinct_hostmerge(reads, k, device="cpu") == want
    assert T.count_distinct(reads, k, device="cpu") == want


def test_k_above_31_raises():
    reads = TF.ReadSet(["a"], [np.zeros(100, np.uint8)])
    with pytest.raises(ValueError, match="1 to 31 bases"):
        T.count_distinct(reads, 32, device="cpu")


def total_kmers(text):
    return re.search(r"Total k-mers (\d+)", text).group(1)


@pytest.mark.parametrize("case,flags", [
    ("random", []), ("poly-A", []), ("with-N", []),
    ("random", ["--min-ovlp", "6000", "--kmer", "13"]),
])
def test_cli_total_kmers_against_jax(cases, tmp_path, capsys, case, flags):
    cfg = tmp_path / "k.cfg"
    I.write_config(cfg)
    argv = ["--reads", str(cases[case]), "--config", str(cfg), *flags]
    assert cli.main(["run", "kmer-cnt", *argv]) == 0
    ours = capsys.readouterr().err
    assert J.run(argv) == 0
    theirs = capsys.readouterr().err
    assert total_kmers(ours) == total_kmers(theirs)
    assert re.search(r"Kernel time: \d+\.\d{3} sec", ours)
    assert [ln for ln in ours.splitlines() if "Kernel time" not in ln] == \
        [ln for ln in theirs.splitlines() if "Kernel time" not in ln]


def test_cli_minimizers_against_jax(cases, tmp_path, capsys):
    cfg = tmp_path / "m.cfg"
    I.write_config(cfg, k=15, use_minimizers=1, window=5)
    argv = ["--reads", str(cases["random"]), "--config", str(cfg)]
    assert cli.main(["run", "kmer-cnt", *argv]) == 0
    ours = capsys.readouterr().err
    assert J.run(argv) == 0
    theirs = capsys.readouterr().err
    pick = [ln for ln in ours.splitlines() if "Minimizers" in ln]
    assert pick and pick == [ln for ln in theirs.splitlines()
                             if "Minimizers" in ln]
    assert total_kmers(ours) == total_kmers(theirs)


@pytest.mark.parametrize("k,w", [(11, 5), (15, 8), (17, 3), (11, 1)])
def test_minimizers_against_jax(k, w):
    rng = np.random.default_rng(k * 10 + w)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[500:900] = 0                  # equal hashes: the tie rules
    codes[1200:1600] = np.tile(np.array([0, 1], np.uint8), 200)
    ours = T.yield_minimizers(codes, k, w)
    assert ours == J.yield_minimizers(codes, k, w)
    if w > 1:
        pos, fwd, canon = T._minimizer_arrays(codes, k, w)
        h = T._splitmix64_arr(T._minimizer_arrays(codes, k, 1)[2])
        assert np.array_equal(native.minimizer_scan(h, w),
                              T._deque_scan_py(h, w))
        assert pos.tolist() == [p for p, _ in ours]
    assert T._kmer_hash(12345) == J._kmer_hash(12345)


def test_minimizer_scan_edges():
    for h, w in ((np.zeros(0, np.uint64), 3), (np.ones(5, np.uint64), 3),
                 (np.arange(10, 0, -1, dtype=np.uint64), 4),
                 (np.array([5, 1, 1, 7, 1, 9, 9, 2], np.uint64), 2)):
        assert np.array_equal(native.minimizer_scan(h, w),
                              T._deque_scan_py(h, w))


def test_minimizer_index_against_jax(cases):
    reads = TF.read_fasta(str(cases["poly-A"]))
    jreads = JF.read_fasta(str(cases["poly-A"]))
    for k, w in ((11, 5), (15, 8)):
        assert T.build_minimizer_index(reads, k, w) == \
            J.build_minimizer_index(jreads, k, w)


def fastq_text(rng, lens):
    out = []
    for i, n in enumerate(lens):
        s = random_seq(rng, n, "ACGTNacgt")
        out.append(f"@q{i} extra words\n{s}\n+\n{'I' * n}\n")
    return "".join(out)


@pytest.fixture(scope="module")
def read_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("fasta")
    rng = np.random.default_rng(9)
    lens = [50, 120, 77, 120, 3, 0, 200]
    fa = d / "r.fa"
    write_reads(fa, [random_seq(rng, n, "ACGTNRYacgtn") for n in lens],
                width=60)
    fq = d / "r.fq"
    fq.write_text(fastq_text(rng, lens))
    out = {"fasta": fa, "fastq": fq}
    for name in ("fasta", "fastq"):
        gz = d / f"r.{name}.gz"
        with gzip.open(gz, "wb") as f:
            f.write(out[name].read_bytes())
        out[name + ".gz"] = gz
    return out


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fasta.gz", "fastq.gz"])
@pytest.mark.parametrize("min_len", [0, 77, 120, 119])
def test_fasta_reader_against_plain_and_jax(read_files, kind, min_len):
    """min_len at a read's exact length drops it (len > min_len)."""
    path = str(read_files[kind])
    got = TF.read_fasta(path, min_len)
    for other in (TF._read_fasta_py(path, min_len),
                  JF._read_fasta_py(path, min_len),
                  JF.read_fasta(path, min_len)):
        assert got.names == other.names
        assert len(got.seqs) == len(other.seqs)
        for a, b in zip(got.seqs, other.seqs):
            assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert all(len(s) > min_len for s in got.seqs)


def test_fasta_reader_missing_file_raises(tmp_path):
    with pytest.raises(OSError, match="cannot read"):
        TF.read_fasta(str(tmp_path / "absent.fa"))


def test_load_kv_config_against_jax(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "base.cfg").write_text(
        "# base\nkmer_size = 15\nminimizer_window=7  # trailing\n")
    main = tmp_path / "sub" / "main.cfg"
    main.write_text("%include base.cfg\n\n  kmer_size = 21 \n"
                    "use_minimizers = 1\nnot a pair\n# kmer_size = 9\n")
    got = load_kv_config(str(main))
    assert got == JC.load_kv_config(str(main))
    assert got == {"kmer_size": "21", "minimizer_window": "7",
                   "use_minimizers": "1"}
    assert T.parse_config(str(main)) == got


def test_bench_fasta_matches_bench_py(tmp_path, monkeypatch):
    """bench.py:50-67's kmer-cnt input, run from bench.py's own source
    (at 12 reads, its BENCH_KMER_READS) with its output directory moved,
    against the copy."""
    monkeypatch.setenv("BENCH_KMER_READS", "12")
    monkeypatch.delenv("BENCH_KMER_READLEN", raising=False)
    fn = next(n for n in ast.walk(ast.parse((REPO / "bench.py").read_text()))
              if isinstance(n, ast.FunctionDef) and n.name == "gen_inputs")
    src = [ast.unparse(s) for s in fn.body]
    lo = src.index("rng = np.random.default_rng(4242)")
    hi = src.index("paths['kmer_bases'] = total")
    env = {"np": np, "os": os, "TMP": tmp_path, "KMER_K": I.BENCH_K}
    exec(compile("\n".join(["paths = {}"] + src[lo:hi + 1]), "bench.py",
                 "exec"), env)
    fa, cfg = env["paths"]["kmer"]
    ours, mine = tmp_path / "ours.fa", tmp_path / "ours.cfg"
    assert I.bench_fasta(ours, n_reads=12) == env["paths"]["kmer_bases"]
    assert fa.read_bytes() == ours.read_bytes()
    I.write_config(mine)
    assert cfg.read_text() == mine.read_text()


def test_slice_modules_import_no_jax():
    """This slice's modules imported in a fresh process (this one holds
    jax) bring in neither jax nor the JAX package."""
    import subprocess
    import sys
    mods = ["genarchbench_tpu_torch.kernels.kmer",
            "genarchbench_tpu_torch.kernels.dbg",
            "genarchbench_tpu_torch.kernels.pileup",
            "genarchbench_tpu_torch.io.fasta_io",
            "genarchbench_tpu_torch.core.config"]
    code = (f"import sys, {', '.join(mods)}; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'genarchbench_tpu')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
