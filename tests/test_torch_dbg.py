"""The port's dbg path against the JAX package, on the CPU, all exact:
the admissibility masks (`_admissible_device`, `_window_min_mask`) with
N bases, low qualities and lengths near k; `cli run dbg`'s lines at
verbose 1 by the sorted rule against the JAX `dbg.run` on
`tests/test_dbg.py::make_case`'s inputs (seeds 0-2, a sub-region) and on
an input whose k-mers hold a non-ACGT base (the 15-byte void dedup
path); the input generator against the JAX test's, byte for byte."""

import ast
import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.kernels import dbg as J
from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.kernels import dbg as T
from tests import test_dbg
from tests import torch_dbg_inputs as I

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def read_arrays(rng, lens, L):
    isn = np.zeros((len(lens), L), bool)
    qual = np.zeros((len(lens), L), np.int32)
    for i, n in enumerate(lens):
        isn[i, :n] = rng.random(n) < 0.02
        qual[i, :n] = rng.integers(15, 41, n)
        qual[i, :n][rng.random(n) < 0.02] = 5
    return isn, qual, np.asarray(lens, np.int32)


@pytest.mark.parametrize("k", [15, 7, 1])
def test_admissible_device_against_jax(k):
    rng = np.random.default_rng(k)
    L = 256
    lens = [0, 1, k - 1, k, k + 1, k + 2, 150, 255, 256]
    isn, qual, lens = read_arrays(rng, lens, L)
    want = np.asarray(J._admissible_device(isn, qual, lens, k=k))
    got = T._admissible_device(torch.from_numpy(isn), torch.from_numpy(qual),
                               torch.from_numpy(lens), k)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


def test_window_min_mask_against_jax():
    rng = np.random.default_rng(4)
    seqs, quals = [], []
    for n in (150, 16, 15, 3, 140, 150):
        seqs.append("".join("ACGTNR"[c] for c in
                            rng.choice(6, n, p=[.24, .24, .24, .24, .02,
                                                .02])))
        q = rng.integers(10, 40, n).astype(np.uint8)
        quals.append(q)
    got = T._window_min_mask(seqs, quals, device="cpu")
    want = J._window_min_mask(seqs, quals)
    for a_list, b_list in zip(got, want):
        assert len(a_list) == len(b_list)
        for a, b in zip(a_list, b_list):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert T._window_min_mask([], [], device="cpu") == ([], [], [])


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["run", "dbg", *argv]) == 0
    return out.getvalue()


def run_jax(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert J.run(argv) == 0
    return out.getvalue()


def sorted_lines(text):
    return sorted(ln for ln in text.splitlines() if ln.strip())


def both(bam, region, fa, verbose=1):
    argv = [str(bam), region, str(fa), "1", str(verbose)]
    return run_port(argv), run_jax(argv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cli_against_jax(tmp_path, capsys, seed):
    bam, fa = I.make_case(tmp_path, np.random.default_rng(seed), TB)
    ours, theirs = both(bam, "tig1:1-5000", fa)
    assert ours.count("\n") == 7
    assert sorted_lines(ours) == sorted_lines(theirs)
    err = capsys.readouterr().err
    assert "Found 7 batches. Running with threads: 1" in err
    assert "Kernel runtime: " in err


def test_cli_subregion_against_jax(tmp_path):
    bam, fa = I.make_case(tmp_path, np.random.default_rng(7), TB,
                          ref_len=8000, n_reads=80)
    ours, theirs = both(bam, "tig1:2001-6000", fa)
    assert ours and sorted_lines(ours) == sorted_lines(theirs)


def test_cli_verbose_0_prints_no_lines(tmp_path, capsys):
    bam, fa = I.make_case(tmp_path, np.random.default_rng(3), TB)
    assert both(bam, "tig1:1-5000", fa, verbose=0) == ("", "")
    assert "Kernel runtime: " in capsys.readouterr().err


def test_cli_void_path_against_jax(tmp_path):
    """k-mers with non-ACGT bases: an N run in the reference, IUPAC
    codes in reads (an R is no N, so the mask admits its windows), which
    send their windows to the 15-byte void dedup."""
    rng = np.random.default_rng(11)
    ref = list("".join("ACGT"[c] for c in rng.integers(0, 4, 4000)))
    ref[1800:1803] = "NNN"
    ref = "".join(ref)
    fa = tmp_path / "ref.fa"
    fa.write_text(">tig1\n" + "".join(ref[i:i + 70] + "\n"
                                      for i in range(0, len(ref), 70)))
    records = []
    for i in range(40):
        pos = int(rng.integers(0, len(ref) - 150))
        s = list(ref[pos:pos + 150])
        if i % 3 == 0:
            s[int(rng.integers(20, 130))] = "RYMK"[i % 4]
        records.append(TB.BamRecord(f"r{i}", 16 * (i % 2), 0, pos, 40,
                                    [(0, 150)], "".join(s),
                                    rng.integers(20, 40, 150).astype(
                                        np.uint8)))
    records.sort(key=lambda r: r.pos)
    bam = tmp_path / "r.bam"
    TB.write_bam(str(bam), [("tig1", len(ref))], records)
    ours, theirs = both(bam, "tig1:1-4000", fa)
    assert ours and sorted_lines(ours) == sorted_lines(theirs)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_case_matches_the_jax_test(tmp_path, seed):
    """tests/test_dbg.py::make_case against the copy, both writers."""
    kw = dict(ref_len=3000, n_reads=40)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = test_dbg.make_case(tmp_path / "jax", np.random.default_rng(seed),
                              **kw)
    for writer in (TB, JB):
        got = I.make_case(tmp_path / "port", np.random.default_rng(seed),
                          writer, **kw)
        for a, b in zip(got, want):
            assert a.read_bytes() == b.read_bytes()
        for suffix in (".bai", ".fai"):
            a = pathlib.Path(str(got[0 if suffix == ".bai" else 1]) + suffix)
            b = pathlib.Path(str(want[0 if suffix == ".bai" else 1]) + suffix)
            assert a.read_bytes() == b.read_bytes()


def test_bench_case_matches_bench_py():
    """bench.py:132-139's dbg call: the seed and sizes of bench_case."""
    call = next(n for n in ast.walk(ast.parse((REPO / "bench.py").read_text()))
                if isinstance(n, ast.Call) and ast.unparse(n.func)
                == "make_case")
    assert ast.unparse(call.args[1]) == \
        f"np.random.default_rng({I.BENCH['seed']})"
    assert {k.arg: ast.literal_eval(k.value) for k in call.keywords} == \
        {k: v for k, v in I.BENCH.items() if k != "seed"}
