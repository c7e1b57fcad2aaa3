"""The port's pileup path against the JAX package, on the CPU, all exact:
`calculate_pileup` (majors, minors, matrix, buffer columns) against
JAX's; the C event walker against its numpy plain version; the
scatter-add against JAX's device route (`GENARCH_PILEUP_DEVICE_SCATTER`
set for the JAX call only); `cli run pileup`'s stdout byte for byte
against the JAX `pileup.run` on tests/test_pileup.py's shapes (several
seeds and regions, a region over several 100 kb chunks, a dense chunk
boundary); the input generator against the JAX test's, byte for byte."""

import ast
import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.kernels import pileup as J
from genarchbench_tpu_torch import cli, native
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.kernels import pileup as T
from tests import test_pileup
from tests import torch_pileup_inputs as I

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    monkeypatch.delenv("GENARCH_PILEUP_DEVICE_SCATTER", raising=False)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Both packages' records of one make_bam BAM (80 reads over two
    contigs: soft clips, insertions, deletions, refskips, N bases,
    secondary and mapq-0 reads)."""
    path = tmp_path_factory.mktemp("pileup") / "t.bam"
    I.make_bam(path, np.random.default_rng(21), TB, n_reads=80)
    return TB.read_bam(str(path))[1], JB.read_bam(str(path))[1]


CHUNKS = [(0, 0, 2000), (1, 0, 2000), (0, 99, 1500), (1, 700, 701),
          (0, 1990, 2600), (1, 2100, 2200)]


@pytest.mark.parametrize("chrom,start,end", CHUNKS)
def test_calculate_pileup_against_jax(case, chrom, start, end):
    recs, jrecs = case
    stats = {}
    got = T.calculate_pileup(recs, chrom, start, end, device="cpu",
                             stats=stats)
    want = J.calculate_pileup(jrecs, chrom, start, end)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    assert got[3] == want[3]
    assert stats["cols"] == len(got[0])
    dev = T.calculate_pileup(recs, chrom, start, end, device_out=True,
                             device="cpu")[2]
    if len(got[0]):
        assert torch.is_tensor(dev) and dev.dtype == torch.int32
        assert np.array_equal(dev.numpy(), got[2])


@pytest.mark.parametrize("chrom,start,end", CHUNKS)
def test_c_walker_against_plain(case, chrom, start, end):
    recs, _ = case
    got = native.pileup_events(T._flatten_records(recs), chrom, start, end,
                               T.FILTER_FLAGS, T.NUM2COUNTBASE)
    want = T._events_plain(recs, chrom, start, end)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_scatter_against_jax_device_route(case, monkeypatch):
    """The port's scatter-add and JAX's `.at[].add(mode="drop")` route on
    the same events (JAX's numpy walker feeds it under the switch)."""
    recs, _ = case
    cov, present, ev_p, ev_j, ev_f = T._events_plain(recs, 0, 0, 2000)
    colof, ncols = T._column_layout(cov, present, 0, 2000)[2:4]
    cols = (colof[ev_p] + ev_j).astype(np.int32)
    # a few indices past the matrix, which both drop
    cols = np.concatenate([cols, [ncols, ncols + 3]]).astype(np.int32)
    feats = np.concatenate([ev_f, [0, 7]]).astype(np.int32)
    monkeypatch.setenv("GENARCH_PILEUP_DEVICE_SCATTER", "1")
    want = np.asarray(J._scatter_counts(cols, feats, ncols))
    monkeypatch.delenv("GENARCH_PILEUP_DEVICE_SCATTER")
    colof_ext = torch.from_numpy(np.arange(ncols + 5, dtype=np.int32) - 1)
    got = T._scatter_counts(colof_ext, torch.from_numpy(cols + 1),
                            torch.from_numpy(feats), ncols)
    assert got.shape == (ncols, T.WIDTH) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # JAX's default host route agrees too
    assert np.array_equal(np.asarray(J._scatter_counts(cols, feats, ncols)),
                          want)


def run_port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["run", "pileup", *argv]) == 0
    return out.getvalue()


def run_jax(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert J.run(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("seed,region", [
    (1, "tig1:1-2000"), (2, "tig2:100-1500"), (3, "tig1:1-2000"),
    (3, "tig2"), (4, "tig1:1500-1501")])
def test_cli_against_jax(tmp_path, capsys, seed, region):
    bam = tmp_path / "t.bam"
    I.make_bam(bam, np.random.default_rng(seed), TB, n_reads=60)
    argv = [str(bam), region, "1"]
    ours = run_port(argv)
    assert ours == run_jax(argv)
    assert "pileup is length" in ours
    assert "Kernel runtime: " in capsys.readouterr().err


@pytest.mark.parametrize("shape", ["multi_chunk", "dense_boundary"])
def test_cli_chunks_against_jax(tmp_path, shape):
    """test_pileup.py:145-175: a region over three 100 kb chunks, and
    reads dense across the 100 kb boundary (the one-column overlap)."""
    bam = tmp_path / "t.bam"
    if shape == "multi_chunk":
        I.single_contig_bam(bam, np.random.default_rng(4), TB, 250000, 50,
                            200)
        region = "big:1-250000"
    else:
        I.single_contig_bam(bam, np.random.default_rng(5), TB, 220000, 30,
                            500, pos_lo=99000, pos_span=2000)
        region = "big:1-220000"
    argv = [str(bam), region, "1"]
    ours = run_port(argv)
    assert ours == run_jax(argv)
    assert ours.count("pileup is length") == 3


def test_flatten_cache_follows_the_list(case):
    """A record list freed after its flattening leaves its id free for the
    next list (CPython hands a freed list's memory to the next one): the
    cache must give that list its own arrays, as when one process runs
    over one BAM, then another."""
    recs, _ = case
    first = recs[:30]
    T._flatten_records(first)
    del first
    second = recs[30:]
    flat = T._flatten_records(second)
    assert flat[0] == len(second)
    assert np.array_equal(flat[1], [r.pos for r in second])
    got = native.pileup_events(flat, 0, 0, 2000, T.FILTER_FLAGS,
                               T.NUM2COUNTBASE)
    want = T._events_plain(second, 0, 0, 2000)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_empty_chunk(case):
    recs, jrecs = case
    got = T.calculate_pileup(recs, 0, 5000, 6000, device_out=True,
                             device="cpu")
    want = J.calculate_pileup(jrecs, 0, 5000, 6000)
    assert got[0].shape == (0,) and got[2].shape == (0, T.WIDTH)
    assert got[3] == want[3] == 2000


@pytest.mark.parametrize("seed", [1, 5])
def test_make_bam_matches_the_jax_test(tmp_path, seed):
    """tests/test_pileup.py::make_bam against the copy, both writers."""
    want = tmp_path / "jax.bam"
    test_pileup.make_bam(want, np.random.default_rng(seed), n_reads=50)
    for writer in (TB, JB):
        got = tmp_path / f"{writer.__name__}.bam"
        I.make_bam(got, np.random.default_rng(seed), writer, n_reads=50)
        assert got.read_bytes() == want.read_bytes()
        assert pathlib.Path(str(got) + ".bai").read_bytes() == \
            pathlib.Path(str(want) + ".bai").read_bytes()


def test_bench_bam_matches_bench_py():
    """bench.py:125-130's pileup call: the seed and sizes of bench_bam."""
    call = next(n for n in ast.walk(ast.parse((REPO / "bench.py").read_text()))
                if isinstance(n, ast.Call) and ast.unparse(n.func)
                == "make_bam")
    assert ast.unparse(call.args[1]) == \
        f"np.random.default_rng({I.BENCH['seed']})"
    assert {k.arg: ast.literal_eval(k.value) for k in call.keywords} == \
        {k: v for k, v in I.BENCH.items() if k != "seed"}
    src = (REPO / "bench.py").read_text()
    assert f'paths["pileup"] = (pile_bam, "{I.BENCH_REGION}")' in src


def test_bam_constants_equal_jax():
    for name in ("FUNMAP", "FSECONDARY", "FQCFAIL", "FDUP", "FSUPPL",
                 "FREVERSE", "CIGAR_OPS", "QRY_CONSUME", "REF_CONSUME"):
        assert getattr(TB, name) == getattr(JB, name), name
    assert T.FILTER_FLAGS == J.FILTER_FLAGS
    assert np.array_equal(T.NUM2COUNTBASE, J.NUM2COUNTBASE)
