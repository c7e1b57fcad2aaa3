"""The port's fmi path against the JAX package, on the CPU.

Every comparison is exact: `search_reads`' (rid, m, n) arrays and the
CLI's SMEM lines (`^\\d+:$|^\\[`) against the JAX package's `fmi.run` on
tests/test_fmi.py's parameter sets, its N-read case and a tandem-repeat
reference whose items retry at the wide prev-list tiers; the wide
(int64-row) path against the same lines; the CLI's index sources; the
item sweep in small chunks; the refusal of long reads.  The JAX runs
are made once, in a module fixture.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from genarchbench_tpu.kernels import fmi as J
from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.kernels import fmi as T
from tests.torch_fmi_inputs import gen_case, smem_lines, tandem_case

# name: (input, batch_size, minSeedLen); test_fmi.py's three sets, its
# N-read case, and the tandem repeats (two reads of N alone at the end)
CASES = {
    "set0": (lambda d: gen_case(d, np.random.default_rng(0), n_reads=24,
                                err=0.05), 8, 19),
    "set1": (lambda d: gen_case(d, np.random.default_rng(1), n_reads=16,
                                err=0.15), 16, 19),
    "set2": (lambda d: gen_case(d, np.random.default_rng(2), n_reads=12,
                                err=0.02), 4, 10),
    "n-reads": (lambda d: gen_case(d, np.random.default_rng(3), n_reads=12,
                                   err=0.08, with_n=True), 8, 19),
    "tandem": (lambda d: tandem_case(d, np.random.default_rng(5)), 8, 19),
}


def stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) in (0, None)
    return buf.getvalue()


def argv_of(c, ref=None):
    return [str(ref or c["fa"]), str(c["fq"]), str(c["batch"]),
            str(c["seed"]), "1"]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Per case: its files, parameters and the JAX package's SMEM lines."""
    out = {}
    for name, (make, batch, seed) in CASES.items():
        fa, fq = make(tmp_path_factory.mktemp(name))
        c = dict(fa=fa, fq=fq, batch=batch, seed=seed)
        c["lines"] = smem_lines(stdout_of(J.run, argv_of(c)))
        out[name] = c
    return out


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    monkeypatch.delenv("GENARCH_FMI_FORCE_WIDE", raising=False)


def search(c, stats=None):
    fmi = T.FMISearch(T.build_index_from_fasta(str(c["fa"])), device="cpu")
    return fmi, T.search_reads(fmi, T.read_queries(str(c["fq"])),
                               c["batch"], c["seed"], stats=stats)


@pytest.mark.parametrize("name", list(CASES))
def test_search_reads_equal(oracle, name):
    c = oracle[name]
    stats = {}
    _, res = search(c, stats)
    (r, m, n), = res
    assert r.dtype == m.dtype == n.dtype == np.int32
    assert smem_lines(T.smem_text(res)) == c["lines"]
    assert stats["smems"] == len(r) > 0
    retries = stats["pass1_retries"]
    if name == "tandem":
        # homopolymer and short-unit reads fill their prev lists past 16
        # and 64 entries: the 64-wide and the full-width tiers both run
        assert retries.get(64, 0) > 0 and retries.get(128, 0) > 0
    else:
        assert not retries


@pytest.mark.parametrize("name", list(CASES))
def test_cli_equal(oracle, name, capsys):
    c = oracle[name]
    assert cli.main(["run", "fmi", *argv_of(c)]) == 0
    out = capsys.readouterr().out
    assert smem_lines(out) == c["lines"]
    assert f"totalSmems = {sum(ln[0] == '[' for ln in c['lines'])}" in out
    assert "Computing time: " in out


@pytest.mark.parametrize("name", ["set0", "n-reads", "tandem"])
def test_wide_rows(oracle, name, monkeypatch):
    """GENARCH_FMI_FORCE_WIDE=1 runs the int64-row path (the counts in
    split words, 16 int32 words a row) on a small index."""
    monkeypatch.setenv("GENARCH_FMI_FORCE_WIDE", "1")
    c = oracle[name]
    fmi, res = search(c)
    assert fmi.wide and fmi.occ.shape[1] == 16
    assert fmi.rowdt == torch.int64
    assert smem_lines(T.smem_text(res)) == c["lines"]


def test_no_header_after_the_last_smem(oracle):
    """The tandem case's last two reads are N alone: no SMEM, and, as in
    the JAX package, no `rid:` line for them."""
    lines = oracle["tandem"]["lines"]
    heads = [int(ln[:-1]) for ln in lines if ln.endswith(":")]
    assert heads == list(range(len(heads)))
    assert heads[-1] < 22 and lines[-1].startswith("[")


def test_index_sources(oracle, tmp_path, capsys):
    """The CLI finds its index as a `.bwt.2bit.64` beside the fasta, as
    that file named itself, and as an `.npz`; each gives the same
    lines."""
    c = oracle["set0"]
    ref = tmp_path / "ref.fa"
    ref.write_text(c["fa"].read_text())
    idx, sa = T.build_index_artifacts(T.read_fasta_codes(str(ref)))
    T.save_bwt2bit64(idx, sa, str(ref) + ".bwt.2bit.64")
    idx.save(str(tmp_path / "idx.npz"))
    for src in (ref, str(ref) + ".bwt.2bit.64", tmp_path / "idx.npz"):
        assert cli.main(["run", "fmi", *argv_of(c, src)]) == 0
        assert smem_lines(capsys.readouterr().out) == c["lines"]


def test_small_chunks(oracle, monkeypatch):
    """Every sweep split into chunks of 7 lanes gives the same lines."""
    monkeypatch.setattr(T, "lanes_per_chunk", lambda dev, nbytes: 7)
    c = oracle["set0"]
    stats = {}
    _, res = search(c, stats)
    assert smem_lines(T.smem_text(res)) == c["lines"]
    assert stats["pass1_chunks"] > 2 and stats["restart_calls"] > 2


def test_long_reads_refused():
    """The JAX package pads reads to a power of two held in 16 bits, so
    a read over 32768 bases is refused by both."""
    fmi = T.FMISearch(T.build_index(np.zeros(64, np.uint8)), device="cpu")
    reads = [np.zeros(100, np.uint8), np.zeros(32769, np.uint8)]
    with pytest.raises(ValueError, match="65535"):
        T.search_reads(fmi, reads, 8, 19)
    with pytest.raises(ValueError, match="65535"):
        J.search_reads(None, reads, 8, 19)
