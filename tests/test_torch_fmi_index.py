"""The port's fmi index and device functions against the JAX package, on
the CPU.

Every comparison is exact: the C SA-IS against the prefix-doubling plain
version and the JAX build's suffix array, the `.bwt.2bit.64` writer byte
for byte, both loaders (compressed and full suffix array) and the `.npz`
round trip, GET_OCC and backwardExt on chosen rows (narrow against JAX,
wide against narrow), and each pass's device function against its JAX
twin on one index and query db: restart_scan against
`_restart_scan_device`, onepos_search against
`_onepos_items_device(packed=False)` at P = 8 and 16, bwt_seed against
`_bwt_seed_device`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genarchbench_tpu.kernels import fmi as J
from genarchbench_tpu_torch import convert, native
from genarchbench_tpu_torch.kernels import fmi as T
from tests.torch_fmi_inputs import bench_input, gen_case, tandem_case

FIELDS = ("count", "cp_count", "oh_hi", "oh_lo", "sentinel", "seq_len")
RCAP = 2


def assert_index_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.array_equal(x, y), f
        assert np.asarray(x).dtype == np.asarray(y).dtype, f


def codes_of(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


SA_INPUTS = {
    "random": lambda: codes_of(np.random.default_rng(0), 3000),
    "periodic": lambda: np.tile(np.arange(4, dtype=np.uint8), 500),
    "homopolymer": lambda: np.zeros(1000, np.uint8),
    "one": lambda: np.array([2], np.uint8),
    "empty": lambda: np.zeros(0, np.uint8),
    "fwd-rc": lambda: (lambda c: np.concatenate([c, (3 - c)[::-1]]))(
        codes_of(np.random.default_rng(1), 2500)),
}


@pytest.mark.parametrize("name", list(SA_INPUTS))
def test_sais_matches_plain(name):
    codes = SA_INPUTS[name]()
    sa = native.sais(codes)
    assert sa.dtype == np.int64
    np.testing.assert_array_equal(sa, T.suffix_array_plain(codes))


def test_sais_refuses_large_codes():
    with pytest.raises(ValueError, match="below 255"):
        native.sais(np.array([1, 255], np.uint8))


def test_build_matches_jax():
    codes = codes_of(np.random.default_rng(2), 4000)
    jidx, jsa = J.build_index_artifacts(codes)
    tidx, tsa = T.build_index_artifacts(codes)
    np.testing.assert_array_equal(tsa, jsa)
    assert_index_equal(tidx, jidx)
    assert_index_equal(convert.fmi_index_from_jax(
        *(getattr(jidx, f) for f in FIELDS)), jidx)


def test_bwt2bit64_byte_identical(tmp_path):
    codes = codes_of(np.random.default_rng(9), 5000)
    jidx, jsa = J.build_index_artifacts(codes)
    tidx, tsa = T.build_index_artifacts(codes)
    jp, tp = tmp_path / "jax.bwt.2bit.64", tmp_path / "port.bwt.2bit.64"
    J.save_bwt2bit64(jidx, jsa, str(jp))
    T.save_bwt2bit64(tidx, tsa, str(tp))
    assert tp.read_bytes() == jp.read_bytes()
    # each package loads the other's file to equal tables
    assert_index_equal(T.FMIndex.load_bwt2bit64(str(jp)), tidx)
    assert_index_equal(J.FMIndex.load_bwt2bit64(str(tp)), jidx)


def test_full_sa_file(tmp_path):
    """The layout without SA_COMPRESSION: the whole suffix array and no
    trailing sentinel, which the loader derives."""
    codes = codes_of(np.random.default_rng(10), 3000)
    tidx, sa_full = T.build_index_artifacts(codes)
    path = tmp_path / "full.bwt.2bit.64"
    rec = np.dtype([("cnt", "<i8", (4,)), ("oh", "<u8", (4,))])
    cp = np.zeros(len(tidx.cp_count), rec)
    cp["cnt"] = tidx.cp_count
    cp["oh"] = ((tidx.oh_hi.astype(np.uint64) << np.uint64(32))
                | tidx.oh_lo.astype(np.uint64))
    with open(path, "wb") as f:
        np.int64(tidx.seq_len).tofile(f)
        (tidx.count.astype(np.int64) - 1).tofile(f)
        cp.tofile(f)
        ((sa_full >> 32) & 0xFF).astype(np.int8).tofile(f)
        (sa_full & 0xFFFFFFFF).astype(np.uint32).tofile(f)
    assert_index_equal(T.FMIndex.load_bwt2bit64(str(path)), tidx)
    assert T.FMIndex.load_bwt2bit64(str(path)).sentinel == \
        J.FMIndex.load_bwt2bit64(str(path)).sentinel


def test_npz_roundtrip(tmp_path):
    tidx = T.build_index(codes_of(np.random.default_rng(4), 3000))
    tidx.save(str(tmp_path / "idx.npz"))
    assert_index_equal(T.FMIndex.load(str(tmp_path / "idx.npz")), tidx)


def test_fasta_with_n_refused(tmp_path):
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\nACGTNACGT\n")
    with pytest.raises(ValueError, match="non-ACGT"):
        T.build_index_from_fasta(str(fa))


def test_bench_input_matches_the_bench_generator(tmp_path):
    """bench.py:108-122, re-run inline at 20 reads, against the copy."""
    rng_f = np.random.default_rng(106)
    ref_len, n_reads, read_len = 2_000_000, 20, 100
    ref = "".join("ACGT"[c] for c in rng_f.integers(0, 4, ref_len))
    fa_text = ">chr1\n" + "".join(ref[i:i + 70] + "\n"
                                  for i in range(0, ref_len, 70))
    fq_text = ""
    for i in range(n_reads):
        p = int(rng_f.integers(0, ref_len - read_len))
        s = list(ref[p:p + read_len])
        for _ in range(5):
            s[int(rng_f.integers(0, read_len))] = \
                "ACGT"[rng_f.integers(0, 4)]
        fq_text += f"@r{i}\n{''.join(s)}\n+\n{'I' * read_len}\n"
    fa, fq = bench_input(tmp_path, n_reads=n_reads)
    assert fa.read_text() == fa_text
    assert fq.read_text() == fq_text


# ---------------------------------------------------------------------------
# the device functions on one index and query db
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The tandem-repeat case (repeats, random stretches, N reads) and
    32 more reads of its reference with 8% substitutions: JAX's tables
    and the port's (narrow and wide) on one index, and the query db in
    the JAX layout (reads padded to 128 bases)."""
    d = tmp_path_factory.mktemp("fmi_index")
    fa, fq = tandem_case(d, np.random.default_rng(5))
    jidx = J.build_index_from_fasta(str(fa))
    port_idx = convert.fmi_index_from_jax(*(getattr(jidx, f)
                                            for f in FIELDS))
    rng = np.random.default_rng(6)
    ref = T.read_fasta_codes(str(fa))
    extra = []
    for p in rng.integers(0, len(ref) - 100, 32):
        r = ref[p:p + 100].copy()
        r[rng.integers(0, 100, 8)] = rng.integers(0, 4, 8)
        extra.append(r if p % 2 else (3 - r)[::-1])
    reads = T.read_queries(str(fq)) + extra
    L = 128
    qdb = np.full(len(reads) * L, 4, np.int32)
    for b, r in enumerate(reads):
        qdb[b * L:b * L + len(r)] = r
    qlen = np.array([len(r) for r in reads], np.int32)
    qoff = np.arange(len(reads), dtype=np.int32) * L
    mp = pytest.MonkeyPatch()
    mp.setenv("GENARCH_FMI_FORCE_WIDE", "1")
    wide = T.FMISearch(port_idx, device="cpu")
    mp.undo()
    return dict(jax=J.FMISearch(jidx), narrow=T.FMISearch(port_idx,
                                                          device="cpu"),
                wide=wide, qdb=qdb, qlen=qlen, qoff=qoff,
                qdb_t=torch.from_numpy(qdb).long(),
                qlen_t=torch.from_numpy(qlen),
                qoff_t=torch.from_numpy(qoff).long())


def test_tables(setup):
    jf, tf, wf = setup["jax"], setup["narrow"], setup["wide"]
    assert not tf.wide and tf.rowdt == torch.int32 and tf.occ.shape[1] == 12
    assert wf.wide and wf.rowdt == torch.int64 and wf.occ.shape[1] == 16
    np.testing.assert_array_equal(
        tf.occ.numpy().view(np.uint32), np.asarray(jf.occtab))
    np.testing.assert_array_equal(tf.count5.numpy(), np.asarray(jf.count5))
    assert int(tf.sentinel) == int(jf.sentinel) == int(wf.sentinel)


def occ_positions(seq_len, sentinel):
    """Rows of the first, a middle and the last checkpoint at offsets
    0, 1, 31, 32, 33 and 63 (those past the BWT dropped), the sentinel
    row and its neighbours, the BWT's end, and random rows."""
    ncp = (seq_len >> 6) + 1
    pp = [c * 64 + y for c in (0, 1, ncp // 2, ncp - 1)
          for y in (0, 1, 31, 32, 33, 63)]
    pp += [sentinel - 1, sentinel, sentinel + 1, seq_len - 1, seq_len]
    pp += np.random.default_rng(11).integers(0, seq_len + 1, 64).tolist()
    return np.array([p for p in pp if 0 <= p <= seq_len], np.int32)


def test_occ4(setup):
    jf, tf, wf = setup["jax"], setup["narrow"], setup["wide"]
    pp = occ_positions(tf.index.seq_len, tf.index.sentinel)
    want = np.asarray(J._occ4(jf.occtab, jnp.asarray(pp)))
    got = T._occ4(tf, torch.from_numpy(pp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got_w = T._occ4(wf, torch.from_numpy(pp).long())
    assert got_w.dtype == torch.int64
    np.testing.assert_array_equal(got_w.numpy(), want)


def intervals(seq_len, sentinel, n=200):
    """Intervals (k, l, s) with k + s <= seq_len, among them intervals
    that start at, end at and straddle the sentinel row, and chars
    a in 0..4 (4 counts as 3)."""
    rng = np.random.default_rng(12)
    k = rng.integers(0, seq_len, n)
    s = np.minimum(rng.integers(0, 300, n), seq_len - k)
    k[:4] = [sentinel, sentinel - 1, sentinel + 1, 0]
    s[:4] = [1, 1, 0, seq_len]
    l = rng.integers(0, seq_len, n)
    a = rng.integers(0, 5, n)
    return [x.astype(np.int32) for x in (k, l, s, a)]


def test_backward_ext(setup):
    jf, tf, wf = setup["jax"], setup["narrow"], setup["wide"]
    k, l, s, a = intervals(tf.index.seq_len, tf.index.sentinel)
    want = J._backward_ext((jf.count5, jf.occtab, jf.sentinel),
                           *(jnp.asarray(x) for x in (k, l, s, a)))
    for f, dt in ((tf, torch.int32), (wf, torch.int64)):
        got = T._backward_ext(f, *(torch.from_numpy(x).to(dt)
                                   for x in (k, l, s)),
                              torch.from_numpy(a).long())
        for g, w in zip(got, want):
            assert g.dtype == dt
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_backward_ext_ks(setup):
    jf, tf, wf = setup["jax"], setup["narrow"], setup["wide"]
    k, _, s, a = intervals(tf.index.seq_len, tf.index.sentinel)
    k, s = k.reshape(25, 8), s.reshape(25, 8)
    a = a[:25]
    want = J._backward_ext_ks((jf.count5, jf.occtab, jf.sentinel),
                              jnp.asarray(k), jnp.asarray(s),
                              jnp.asarray(a)[:, None])
    for f, dt in ((tf, torch.int32), (wf, torch.int64)):
        got = T._backward_ext_ks(f, torch.from_numpy(k).to(dt),
                                 torch.from_numpy(s).to(dt),
                                 torch.from_numpy(a).long())
        for g, w in zip(got, want):
            assert g.dtype == dt
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def unpack_items(out):
    """The JAX package's packed u32 items (x0 << 16 | n, 0xFFFFFFFF for
    none) as (x0, n) int32 with -1 for none."""
    out = np.asarray(out)
    none = out == 0xFFFFFFFF
    return (np.where(none, -1, out >> 16).astype(np.int32),
            np.where(none, -1, out & 0xFFFF).astype(np.int32))


def jax_restart_items(setup):
    """Every restart item of the JAX scan in chain order, resumed every
    RCAP items."""
    jf = setup["jax"]
    x = jnp.zeros(len(setup["qlen"]), jnp.int32)
    chunks = []
    while True:
        out, x = J._restart_scan_device(
            jf.count5, jf.occtab, jf.sentinel, jnp.asarray(setup["qdb"]),
            jnp.asarray(setup["qoff"]), jnp.asarray(setup["qlen"]), x,
            jnp.asarray(np.int32(1)), Rcap=RCAP)
        chunks.append(unpack_items(out))
        if not (np.asarray(x) < setup["qlen"]).any():
            break
    x0 = np.concatenate([c[0] for c in chunks], 1)
    n = np.concatenate([c[1] for c in chunks], 1)
    bb, rr = np.nonzero(x0 >= 0)
    return bb, x0[bb, rr], n[bb, rr], chunks[0]


@pytest.mark.parametrize("which", ["narrow", "wide"])
def test_restart_scan(setup, which):
    f = setup[which]
    bb, x0, n, first = jax_restart_items(setup)
    out, x = T.restart_scan(f, setup["qdb_t"], setup["qoff_t"],
                            setup["qlen_t"],
                            torch.zeros(len(setup["qlen"]), dtype=torch.int32),
                            1, RCAP)
    np.testing.assert_array_equal(out[:, 0].numpy(), first[0])
    np.testing.assert_array_equal(out[:, 1].numpy(), first[1])
    st = {}
    got = f.restart_items(setup["qdb_t"], setup["qoff_t"], setup["qlen_t"], 1,
                          Rcap=RCAP, stats=st)
    for g, w in zip(got, (bb, x0, n)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert st["restart_calls"] > 1            # some read resumed


def item_meta(setup):
    """(Bp, 4) [qoff, qlen, x0, min_intv] rows: the restart items with
    min_intv 1, the same items from the midpoint of their forward
    extension with min_intv 2..11, then idle rows (-1) up to a power of
    two, as the JAX package pads them."""
    bb, x0, n, _ = jax_restart_items(setup)
    mid = (x0 + n + 1) >> 1
    rows = np.concatenate([
        np.stack([setup["qoff"][bb], setup["qlen"][bb], x0,
                  np.ones_like(x0)], 1),
        np.stack([setup["qoff"][bb], setup["qlen"][bb], mid,
                  2 + np.arange(len(bb)) % 10], 1)]).astype(np.int32)
    Bp = 1 << (len(rows) - 1).bit_length()
    return np.concatenate([rows, np.full((Bp - len(rows), 4), -1, np.int32)])


@pytest.mark.parametrize("which", ["narrow", "wide"])
@pytest.mark.parametrize("P", [8, 16])
def test_onepos_search(setup, P, which):
    jf, f = setup["jax"], setup[which]
    meta = item_meta(setup)
    out_w = 12
    want = [np.asarray(v) for v in J._onepos_items_device(
        jf.count5, jf.occtab, jf.sentinel, jnp.asarray(setup["qdb"]),
        jnp.asarray(meta), Pmax=P, min_seed=10, out_w=out_w, packed=False)]
    mt = torch.from_numpy(meta)
    st = {}
    em, en, es, ec, ovf = T.onepos_search(
        f, setup["qdb_t"], mt[:, 0].long(), mt[:, 1], mt[:, 2], mt[:, 3], P,
        10, out_w, stats=st)
    np.testing.assert_array_equal(ovf.numpy(), want[4])
    ok = ~want[4]
    assert want[4].any() and (want[3][ok] > 1).any()
    np.testing.assert_array_equal(ec.numpy()[ok], want[3][ok])
    slot = np.arange(out_w)[None, :] < want[3][:, None]
    for g, w in zip((em, en, es), want[:3]):
        np.testing.assert_array_equal(np.where(slot, g.numpy(), 0)[ok],
                                      np.where(slot, w, 0)[ok])
    assert st["pass1_fwd_steps"] > 0 and st["pass1_bwd_steps"] > 0


@pytest.mark.parametrize("which", ["narrow", "wide"])
def test_bwt_seed(setup, which):
    jf, f = setup["jax"], setup[which]
    B = len(setup["qlen"])
    jout, jx = J._bwt_seed_device(
        jf.count5, jf.occtab, jf.sentinel, jnp.asarray(setup["qdb"]),
        jnp.asarray(setup["qoff"]), jnp.asarray(setup["qlen"]),
        jnp.asarray(np.int32(20)), jnp.zeros(B, jnp.int32), min_seed=20,
        Rcap=RCAP)
    wx, wn = unpack_items(jout)
    out, x = T.bwt_seed(f, setup["qdb_t"], setup["qoff_t"], setup["qlen_t"],
                        torch.zeros(B, dtype=torch.int32), 20, 20, RCAP)
    np.testing.assert_array_equal(out[:, 0].numpy(), wx)
    np.testing.assert_array_equal(out[:, 1].numpy(), wn)
    # a finished lane's x is past its read in both (JAX's keeps counting)
    np.testing.assert_array_equal(np.minimum(x.numpy(), setup["qlen"]),
                                  np.minimum(np.asarray(jx), setup["qlen"]))
    assert (wn >= 0).any() and (x.numpy() < setup["qlen"]).any()
