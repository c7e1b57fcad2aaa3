"""The PyTorch port's wfa path against the JAX package, on the CPU.

Every comparison is exact: the CIGARs are compared as the sorted
`id=N <cigar>` lines of the kernel's check rule, and the forward pass's
backtrace store word for word.  Batch composition is free in the port
(no padding to multiples of 8, no mesh), so only each pair's CIGAR must
match.
"""

import numpy as np
import pytest
import torch

from genarchbench_tpu.io.seqpair_io import read_seqpairs as jax_read
from genarchbench_tpu.kernels import wfa as jwfa
from genarchbench_tpu_torch import cli, native
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, read_seqpairs
from genarchbench_tpu_torch.kernels import wfa
from tests.synth import gen_seqpair_dataset

# tests/test_wfa.py's datasets: (seed, pairs, length, error rate)
DATASETS = [
    (0, 32, 100, 0.05),
    (1, 48, 100, 0.20),
    (2, 16, 60, 0.02),
    (3, 24, 150, 0.10),
]
# and its adaptive-reduction sets: + (minimum length, maximum distance)
ADAPTIVE = [
    (5, 32, 100, 0.10, 10, 50),
    (6, 24, 150, 0.20, 10, 25),
    (7, 16, 80, 0.05, 5, 10),
]


def write(tmp_path, text, name="pairs.txt"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def synth(tmp_path, seed, n, length, err):
    return write(tmp_path, gen_seqpair_dataset(np.random.default_rng(seed),
                                               n_pairs=n, length=length,
                                               error_rate=err))


def lines(cigars):
    return sorted(f"id={i} {c}" for i, c in enumerate(cigars))


def both(path, stats=None, **kw):
    """(JAX lines, port lines) for the pairs in `path`."""
    want = lines(jwfa.wfa_batch(jax_read(path, swap_longer_first=False), **kw))
    got = lines(wfa.wfa_batch(read_seqpairs(path), device="cpu", stats=stats,
                              **kw))
    return want, got


@pytest.mark.parametrize("seed,n,length,err", DATASETS)
def test_datasets_equal(tmp_path, seed, n, length, err):
    want, got = both(synth(tmp_path, seed, n, length, err))
    assert got == want


def test_scap_retry_equal(tmp_path):
    """Pairs scoring above the initial cap resume the padded state."""
    stats = {}
    want, got = both(synth(tmp_path, 9, 8, 120, 0.45), stats=stats)
    assert got == want
    assert stats["resumes"] >= 1


def test_identical_pair_equal(tmp_path):
    want, got = both(write(tmp_path, ">ACGTACGTAC\n<ACGTACGTAC\n>AC\n<TG\n"))
    assert got == want
    assert got == ["id=0 10M", "id=1 2X"]


def test_mismatch_at_word_ends(tmp_path):
    """Extension stops at bit 31 of a word and at the last word's top bit:
    64-base patterns (two whole words) with single mismatches at 31, 32,
    63 and 0."""
    rng = np.random.default_rng(4)
    text = ""
    for pos in (31, 32, 63, 0):
        a = "".join(rng.choice(list("ACGT"), 64))
        b = a[:pos] + "ACGT"[("ACGT".index(a[pos]) + 1) % 4] + a[pos + 1:]
        text += f">{a}\n<{b}\n"
    want, got = both(write(tmp_path, text))
    assert got == want
    assert got == ["id=0 31M1X32M", "id=1 32M1X31M", "id=2 63M1X",
                   "id=3 1X63M"]


@pytest.mark.parametrize("seed,n,length,err,mlen,mdist", ADAPTIVE)
def test_adaptive_reduction_equal(tmp_path, seed, n, length, err, mlen,
                                  mdist):
    want, got = both(synth(tmp_path, seed, n, length, err), red_len=mlen,
                     red_dist=mdist)
    assert got == want


@pytest.mark.parametrize("mix,merged", [({80: 6, 100: 6}, True),
                                        ({30: 30, 200: 4}, False)])
def test_mixed_lengths_equal(tmp_path, mix, merged):
    """Near-equal length buckets coalesce into one chunk; buckets whose
    merge would more than double the padded cells stay apart."""
    rng = np.random.default_rng(sum(mix))
    text = "".join(gen_seqpair_dataset(rng, n_pairs=n, length=L,
                                       error_rate=0.1)
                   for L, n in mix.items())
    stats = {}
    want, got = both(write(tmp_path, text), stats=stats)
    assert got == want
    assert (stats["chunks"] == 1) == merged


def test_bucket_split_into_chunks_equal(tmp_path):
    """300 pairs of one bucket under max_batch=256: two chunks, the
    second starting at the score cap the first one learned."""
    stats = {}
    want, got = both(synth(tmp_path, 12, 300, 30, 0.1), stats=stats,
                     max_batch=256)
    assert got == want
    assert stats["chunks"] == 2


@pytest.mark.parametrize("pen", [dict(x=4, o=6, e=0), dict(x=0, o=6, e=2)])
def test_degenerate_penalties_equal(tmp_path, pen):
    """min(e, x) = 0: the backtrace has no score-derived step bound and
    runs until every lane finishes."""
    want, got = both(synth(tmp_path, 11, 12, 40, 0.1), **pen)
    assert got == want


def jax_chunk_inputs(path):
    """One chunk's padded arrays as the JAX wfa_batch builds them
    (B a multiple of 8, pattern/text padding 250/251)."""
    pairs = jax_read(path, swap_longer_first=False)
    n = len(pairs)
    Lp = jwfa._round_up(max(len(p) for p in pairs.patterns), 32)
    Lt = jwfa._round_up(max(len(t) for t in pairs.texts), 32)
    pat = np.full((n, Lp), 250, np.uint8)
    txt = np.full((n, Lt), 251, np.uint8)
    for i, (p, t) in enumerate(zip(pairs.patterns, pairs.texts)):
        pat[i, :len(p)] = p
        txt[i, :len(t)] = t
    plen = np.array([len(p) for p in pairs.patterns], np.int32)
    tlen = np.array([len(t) for t in pairs.texts], np.int32)
    return pat, txt, plen, tlen


@pytest.mark.parametrize("red", [(0, 0), (10, 25)])
def test_forward_store_equal(tmp_path, red):
    """The mismatch table and the forward pass's packed backtrace store
    (op codes | run << 8), the bounds rings and the final scores equal
    the JAX functions' on one chunk."""
    pat, txt, plen, tlen = jax_chunk_inputs(synth(tmp_path, 1, 16, 100,
                                                  0.2))
    x, o, e, Scap = 4, 6, 2, 64
    RS = jwfa._ring_size(x, o, e)
    K0, D = jwfa._geometry(pat.shape[1], txt.shape[1], Scap)
    B = pat.shape[0]
    jtbl = jwfa._build_mismatch_table(pat, txt, tlen, K0=K0, D=D)
    jstate = jwfa._init_state(B=B, D=D, Scap=Scap, RS=RS, K0=K0)
    jout, jsumm = jwfa._wfa_forward(pat, txt, plen, tlen, jtbl,
                                    tuple(jstate), K0=K0, D=D, Scap=Scap,
                                    x=x, o=o, e=e, red_len=red[0],
                                    red_dist=red[1])

    t = [torch.from_numpy(a) for a in (pat, txt, plen, tlen)]
    tbl = wfa._build_mismatch_table(t[0], t[1], K0, D)
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    st = wfa._init_state(B, D, Scap, RS, K0, torch.device("cpu"))
    summ = wfa._wfa_forward(t[2], t[3], tbl, st, K0=K0, D=D, Scap=Scap,
                            x=x, o=o, e=e, red_len=red[0], red_dist=red[1])
    assert summ == [int(v) for v in np.asarray(jsumm)]
    assert st.s == int(jout[14])
    np.testing.assert_array_equal(
        st.store.numpy(), np.asarray(jout[12]).view(np.int32))
    for got, k in ((st.mlo, 3), (st.mhi, 4), (st.ilo, 5), (st.ihi, 6),
                   (st.dlo, 7), (st.dhi, 8), (st.mex, 9), (st.iex, 10),
                   (st.dex, 11), (st.done, 15), (st.fscore, 16),
                   (st.foff, 17)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jout[k]))


def random_records(rng, B, T):
    nmats = rng.integers(0, 40, (B, T)).astype(np.int32)
    nmats[rng.random((B, T)) < 0.3] = 0
    ops = rng.integers(0, 4, (B, T)).astype(np.int8)
    gap_t = rng.integers(-1, T, B).astype(np.int32)
    gap_v = rng.integers(-30, 31, B).astype(np.int32)
    fm, fd, fi = (np.where(rng.random(B) < 0.5, 0, rng.integers(0, 20, B))
                  .astype(np.int32) for _ in range(3))
    return nmats, ops, gap_t, gap_v, fm, fd, fi


@pytest.mark.parametrize("T", [0, 1, 7, 64])
def test_native_cigars_equal_plain(T):
    """native/wfa_cigars.c against the plain `_assemble_cigar` on seeded
    random records, with gap runs of both signs and empty CIGARs."""
    rng = np.random.default_rng(T)
    recs = random_records(rng, 40, T)
    recs[0][0] = 0            # lane 0: nothing at all
    recs[1][0] = 0
    recs[2][:] = -1
    for a in recs[4:]:
        a[0] = 0
    got = native.wfa_cigars(*recs)
    want = [wfa._assemble_cigar(*(r[b] for r in recs), T)
            for b in range(40)]
    assert got == want
    assert got[0] == ""
    assert any("D" in c for c in got) and any("I" in c for c in got)


def test_native_cigars_checks_shapes():
    rng = np.random.default_rng(0)
    recs = list(random_records(rng, 4, 5))
    recs[3] = recs[3][:3]
    with pytest.raises(ValueError, match="gap_v must be"):
        native.wfa_cigars(*recs)


def test_cli_matches_jax_run(tmp_path, monkeypatch, capsys):
    """`GENARCH_DEVICE=cpu cli run wfa` writes the JAX run's output file,
    with the same stdout lines, and the CellUpdates line on stderr."""
    from genarchbench_tpu.kernels.wfa import run as jax_run
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    inp = synth(tmp_path, 3, 24, 150, 0.10)
    args = ["--minimum-wavefront-length", "10",
            "--maximum-difference-distance", "25"]
    assert jax_run(["-i", inp, "-o", str(tmp_path / "jax.out"), *args]) == 0
    jcap = capsys.readouterr()
    assert cli.main(["run", "wfa", "-i", inp, "-o", str(tmp_path / "t.out"),
                     *args]) == 0
    cap = capsys.readouterr()
    assert (tmp_path / "t.out").read_text() == \
        (tmp_path / "jax.out").read_text()
    out = cap.out.splitlines()
    assert out[0] == jcap.out.splitlines()[0] == "Total.reads: 24"
    assert out[1].startswith("Time.Alignment: ") and out[1].endswith(" s")
    assert "CellUpdates: " in cap.err


def test_wfa_batch_of_nothing():
    assert wfa.wfa_batch(SeqPairs([], []), device="cpu") == []
