"""The port's nn-variant path against the JAX package, on the CPU.

The models are float32 in both frameworks with the sums taken in other
orders, so probabilities are compared within atol 1e-5 (Clair3P and
Clair3F at full width, on weights carried across by
`convert.variant_state_from_jax` / `variant_full_state_from_jax` or read
from one seeded Keras-scheme npz).  The host functions (pileup and
full-alignment tensors, candidate selection, phasing, VCF rows, merge)
are exact.  `cli run nn-variant` is held to JAX `var.run` on one
`--model` / `--fa-model` npz: the VCF byte for byte but QUAL (within
0.02), and the [INFO] lines equal.  JAX's `run --full-alignment` raises
on sites of different coverage, and its Clair3F raises on row counts its
pooled width does not fit (rows 1-16 and 25-32 at depth 89): the port's
are held there to JAX's per-site `predict`, of the zero-padded tensor
where the row count does not fit.
"""

import contextlib
import io
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.kernels import pileup as JP
from genarchbench_tpu.nn import variant as J
from genarchbench_tpu_torch import cli, convert
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.kernels.pileup import calculate_pileup
from genarchbench_tpu_torch.nn import variant as T
from tests import torch_pileup_inputs as PI
from tests import torch_variant_inputs as I

ATOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def fresh_jax_flatten_cache():
    """JAX's pileup caches a record list's flat arrays by the list's id
    alone, so a new list at a freed list's id would get the old list's
    records (ROADMAP queue 3): clear it before each JAX pileup."""
    JP._FLAT_CACHE.clear()


def j_pileup(records, chrom_id, start, end):
    fresh_jax_flatten_cache()
    return JP.calculate_pileup(records, chrom_id, start, end)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One seeded Clair3_P and one Clair3_F npz in the Keras scheme."""
    d = tmp_path_factory.mktemp("weights")
    I.save_npz(d / "p.npz", I.keras_weights_p(4))
    I.save_npz(d / "f.npz", I.keras_weights_f(2))
    return d / "p.npz", d / "f.npz"


@pytest.fixture(scope="module")
def jax_fa():
    """JAX Clair3F at depth 89 and the port's on its weights."""
    jf = J.FullAlignmentCaller.init(seed=3)
    return jf, T.FullAlignmentCaller(
        convert.variant_full_state_from_jax(jf.variables), device="cpu")


def both_records(tmp_path, records, ref_len, name="c1"):
    """Both packages' records of one BAM written by the port's writer."""
    bam = tmp_path / "x.bam"
    TB.write_bam(str(bam), [(name, ref_len)], records)
    return TB.read_bam(str(bam))[1], JB.read_bam(str(bam))[1]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def test_clair3p_full_width():
    jc = J.PileupCaller.init(seed=0)
    tc = T.PileupCaller(convert.variant_state_from_jax(jc.variables),
                        device="cpu")
    x = (np.random.default_rng(1).normal(size=(8, 33, 18)) * 5) \
        .astype(np.float32)
    got, want = tc.predict(x), jc.predict(x)
    assert got.shape == (8, 90)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_convert_keras_weights_pileup():
    w = I.keras_weights_p(4)
    state = T.convert_keras_weights(w)
    via_jax = convert.variant_state_from_jax(J.convert_keras_weights(w))
    assert state.keys() == via_jax.keys()
    assert all(torch.equal(state[k], via_jax[k]) for k in state)
    x = np.random.default_rng(5).integers(-30, 30, (8, 33, 18)) \
        .astype(np.int32)
    np.testing.assert_allclose(
        T.PileupCaller(state, device="cpu").predict(x),
        J.PileupCaller(J.convert_keras_weights(w)).predict(x),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("rows,width", [(89, 33), (31, 33), (40, 33),
                                        (17, 21)])
def test_clair3f_full_width(rows, width):
    """Each model built at its (rows, width): JAX inits its L4 from the
    input shape, the port from `pooled_features`."""
    model = J.Clair3F()
    jv = model.init(jax.random.PRNGKey(rows),
                    jnp.zeros((1, rows, width, J.FA_CHANNELS)))
    tc = T.FullAlignmentCaller(convert.variant_full_state_from_jax(jv),
                               depth=rows, width=width, device="cpu")
    assert tc.model.L4.in_features == jv["params"]["L4"]["kernel"].shape[0]
    x = np.random.default_rng(rows).integers(
        -100, 101, (2, rows, width, J.FA_CHANNELS)).astype(np.float32)
    np.testing.assert_allclose(tc.predict(x),
                               J.FullAlignmentCaller(jv).predict(x),
                               atol=ATOL, rtol=0)


def test_convert_keras_weights_full():
    w = I.keras_weights_f(6)
    state = T.convert_keras_weights_full(w)
    via_jax = convert.variant_full_state_from_jax(
        J.convert_keras_weights_full(w))
    assert state.keys() == via_jax.keys()
    assert all(torch.equal(state[k], via_jax[k]) for k in state)
    x = np.random.default_rng(7).integers(0, 101, (2, 89, 33, 8)) \
        .astype(np.int32)
    np.testing.assert_allclose(
        T.FullAlignmentCaller(state, device="cpu").predict(x),
        J.FullAlignmentCaller(J.convert_keras_weights_full(w)).predict(x),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,W", [(9, 7), (8, 6)])
def test_basic_conv2d_stride2(H, W):
    """TF-SAME at stride 2 pads the extra row and column at the end."""
    rng = np.random.default_rng(H)
    cin, cout = 3, 4
    x = rng.normal(size=(2, H, W, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    b, g, be, mu = (rng.normal(size=cout).astype(np.float32)
                    for _ in range(4))
    var = rng.uniform(0.5, 2.0, cout).astype(np.float32)
    variables = {"params": {"conv": {"kernel": k, "bias": b},
                            "bn": {"scale": g, "bias": be}},
                 "batch_stats": {"bn": {"mean": mu, "var": var}}}
    want = np.asarray(J.BasicConv2D(cout, strides=2).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    m = T.BasicConv2D(cin, cout, strides=2).eval()
    m.load_state_dict({
        "conv.weight": torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(b), "bn.weight": torch.from_numpy(g),
        "bn.bias": torch.from_numpy(be), "bn.running_mean":
        torch.from_numpy(mu), "bn.running_var": torch.from_numpy(var),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = m(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("H,W", [(7, 10), (12, 5), (11, 13), (4, 5)])
def test_pyramid_pooling(H, W):
    """flax's SAME max-pool, low pads above 0 (H = 7 or W = 10 at p = 3:
    window 3 or 4, total pad 2), and the NHWC flatten order."""
    x = np.random.default_rng(H * W).normal(size=(2, H, W, 5)) \
        .astype(np.float32)
    want = np.asarray(J._pyramid_pooling(jnp.asarray(x)))
    got = T._pyramid_pooling(torch.from_numpy(x.transpose(0, 3, 1, 2)
                                              .copy()))
    assert np.array_equal(got.numpy(), want)
    cells = [(-(-H // -(-H // p)), -(-W // -(-W // p))) for p in (3, 2, 1)]
    assert got.shape[1] == 5 * sum(h * w for h, w in cells)


def test_full_alignment_predict_multi_site(jax_fa):
    """One port call on sites of several row counts equals JAX's predict
    site by site; rows 16 and 31 do not fit the 89-row model, nor does a
    site no read covers (0 rows): JAX raises, and the port runs the
    tensor zero-padded to 89 rows."""
    jf, tf = jax_fa
    rng = np.random.default_rng(8)
    rows = [40, 20, 89, 40, 31, 24, 16, 33, 0]
    sites = [rng.integers(-100, 101, (r, 33, 8)).astype(np.int32)
             for r in rows]
    got = tf.predict(sites)
    for r, x, g in zip(rows, sites, got):
        if tf.model.fits(r):
            want = jf.predict(x[None])[0]
        else:
            with pytest.raises(Exception, match="L4" if r else "window"):
                jf.predict(x[None])
            want = jf.predict(np.concatenate(
                [x, np.zeros((89 - r, 33, 8), np.int32)])[None])[0]
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=0)
    assert [tf.model.fits(r) for r in (16, 17, 24, 25, 32, 33, 89)] == \
        [False, True, True, False, False, True, True]


# ---------------------------------------------------------------------------
# host functions, exact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def edge_case(tmp_path_factory):
    """fa_edge_records around 200 plus two_hap_records, both packages'."""
    rng = np.random.default_rng(23)
    ref = I.random_ref(rng, 400)
    recs = I.fa_edge_records(rng, ref, 200, TB) + I.two_hap_records(
        rng, ref, {150: "A" if ref[150] != "A" else "C"}, TB)
    recs.sort(key=lambda r: r.pos)
    tmp = tmp_path_factory.mktemp("edge")
    return ref, *both_records(tmp, recs, 400)


@pytest.mark.parametrize("center", [200, 150, 8, 392])
def test_pileup_tensor_exact(edge_case, center):
    ref, recs, jrecs = edge_case
    cache = T.ReadCache()
    got = T.pileup_tensor_from_bam(recs, 0, center, ref, cache)
    want = J.pileup_tensor_from_bam(jrecs, 0, center, ref)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(T.pileup_tensor_from_bam(recs, 0, center, ref,
                                                   cache), want)


@pytest.mark.parametrize("center,tags", [(200, "mix"), (200, None),
                                         (215, "mix"), (160, None)])
def test_full_alignment_tensor_exact(edge_case, center, tags):
    """Over 89 covering reads (the downsample), insertions at and past the
    window's right edge, deletions, haplotags 0/1/2."""
    ref, recs, jrecs = edge_case
    haplotags = ({r.qname: i % 3 for i, r in enumerate(recs)}
                 if tags else None)
    state = random.getstate()
    got = T.full_alignment_tensor(recs, 0, center, ref, haplotags)
    assert random.getstate() == state
    want = J.full_alignment_tensor(jrecs, 0, center, ref, haplotags)
    assert got.shape == want.shape and np.array_equal(got, want)
    if center == 200:
        assert got.shape[0] == 89


def test_phase_hets_exact(tmp_path):
    """Hets along a chain of reads, deletions over some of them (no
    allele there), a read of each haplotype, filtered reads."""
    rng = np.random.default_rng(31)
    ref = I.random_ref(rng, 3000)
    sites = {p: ("A" if ref[p] != "A" else "C")
             for p in range(100, 2900, 97)}
    recs = I.two_hap_records(rng, ref, sites, TB, n_reads=160, ln=300,
                             pos_span=2700)
    for k, r in enumerate(recs):
        if k % 7 == 3:                     # a deletion over a het
            p = next((p for p in sorted(sites) if r.pos + 5 < p
                      < r.pos + 290), None)
            if p is not None:
                at = p - r.pos
                r.cigar = [(0, at), (2, 2), (0, 298 - at)]
                r.seq = r.seq[:at] + r.seq[at + 2:]
                r.qual = r.qual[:298]
        if k % 11 == 4:
            r.flag |= 1024
    recs, jrecs = both_records(tmp_path, recs, 3000)
    pos = sorted(sites)
    alts = [sites[p] for p in pos]
    got = T.phase_hets(recs, pos, alts, 0)
    want = J.phase_hets(jrecs, pos, alts, 0)
    assert got == want and set(got.values()) == {1, 2}


def _jax_candidates(majors, minors, mat, ref_seq, min_af):
    """JAX run's candidate loop (variant.py:855-868), verbatim."""
    cands = []
    base_cols = {b: i for i, b in enumerate("acgtACGT")}
    for i in range(len(majors)):
        if minors[i] != 0:
            continue
        pos = int(majors[i])
        ref_b = ref_seq[pos].upper() if pos < len(ref_seq) else "N"
        row = mat[i].reshape(-1, 10).sum(axis=0)
        depth = row.sum()
        if depth == 0 or ref_b not in "ACGT":
            continue
        ref_cnt = row[base_cols[ref_b]] + row[base_cols[ref_b.lower()]]
        if depth - ref_cnt >= max(2, min_af * depth):
            cands.append((pos, ref_b))
    return cands


@pytest.mark.parametrize("min_af", [0.25, 0.1, 0.5])
def test_candidates_exact(tmp_path, min_af):
    """make_bam's reads are random bases, so most columns pass; the
    reference has lowercase, N and IUPAC bases and ends before the
    contig does."""
    path = tmp_path / "c.bam"
    PI.make_bam(path, np.random.default_rng(41), TB, n_reads=60)
    recs, jrecs = TB.read_bam(str(path))[1], JB.read_bam(str(path))[1]
    rng = np.random.default_rng(42)
    ref = "".join(rng.choice(list("ACGTacgtNR"), 1900,
                             p=[.2, .2, .2, .2, .04, .04, .04, .04, .02,
                                .02]))
    majors, minors, mat, _ = calculate_pileup(recs, 0, 0, 2000,
                                              device_out=True, device="cpu")
    got = T.select_candidates(majors, minors, mat, ref, min_af)
    want = _jax_candidates(*j_pileup(jrecs, 0, 0, 2000)[:3], ref, min_af)
    assert got == want and len(got) > 50


def test_merge_and_vcf_rows():
    for label in J.GT21_LABELS:
        for b in "ACGT":
            assert T.gt21_to_alleles(label, b) == J.gt21_to_alleles(label, b)
    rng = np.random.default_rng(51)
    probs = rng.dirichlet(np.ones(21), 64).astype(np.float32)
    probs = np.concatenate([probs, rng.dirichlet(np.ones(3), 64)
                            .astype(np.float32)], 1)
    probs[::9, 0] = 0.999                   # near-certain AA
    pos = list(range(100, 164))
    bases = list(rng.choice(list("ACGT"), 64))
    for cutoff in (0.0, 0.2):
        got = T.rows_from_probs(probs, pos, bases, "c1", cutoff)
        assert got == J.rows_from_probs(probs, pos, bases, "c1", cutoff)
    rows = T.rows_from_probs(probs, pos, bases, "c1")
    fa = rows[::3]
    for examined in (None, {101, 140, 150}, {int(r.split("\t")[1])
                                              for r in rows[1::4]}):
        assert T.merge_vcf_rows(rows, fa, examined) == \
            J.merge_vcf_rows(rows, fa, examined)


# ---------------------------------------------------------------------------
# the CLI against JAX var.run
# ---------------------------------------------------------------------------

def call(fn, argv):
    """(return code, stderr) of fn(argv), its stdout dropped."""
    fresh_jax_flatten_cache()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, err.getvalue()


def port_run(argv):
    return cli.main(["run", "nn-variant", *argv])


def assert_vcf_close(got: str, want: str):
    """Byte for byte but QUAL, which stays within 0.02."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        fa, fb = a.split("\t"), b.split("\t")
        if a.startswith("#") or len(fa) < 6:
            assert a == b
            continue
        assert fa[:5] + fa[6:] == fb[:5] + fb[6:]
        assert abs(float(fa[5]) - float(fb[5])) <= 0.02


def info_lines(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("[INFO]")]


@pytest.fixture(scope="module")
def hap_case(tmp_path_factory):
    """test_variant.py's two-haplotype reads (seed 9): SNPs at 200 (and
    at 60 with `two`)."""
    def make(two: bool):
        d = tmp_path_factory.mktemp("hap")
        rng = np.random.default_rng(9 if not two else 8)
        ref = I.random_ref(rng, 400)
        sites = {200: "A" if ref[200] != "A" else "G"}
        if two:
            sites[60] = "A" if ref[60] != "A" else "C"
        recs = I.two_hap_records(rng, ref, sites, TB)
        TB.write_bam(str(d / "x.bam"), [("c1", 400)], recs)
        (d / "ref.fa").write_text(f">c1\n{ref}\n")
        return d, ref
    return make


def cli_argv(d, weights, out, *extra, region="c1:1-400"):
    return ["--bam", str(d / "x.bam"), "--ref", str(d / "ref.fa"),
            "--region", region, "--model", str(weights[0]), "--fa-model",
            str(weights[1]), "--output", str(out), *extra]


@pytest.mark.parametrize("extra", [
    (), ("--full-alignment", "--fa-qual", "100"),
    ("--full-alignment", "--fa-qual", "100", "--realign")],
    ids=["pileup", "full-alignment", "realign"])
def test_cli_against_jax(hap_case, weights, extra):
    d, _ = hap_case(False)
    rc, err = call(port_run, cli_argv(d, weights, d / "port.vcf", *extra))
    jrc, jerr = call(J.run, cli_argv(d, weights, d / "jax.vcf", *extra))
    assert rc == 0 and jrc == 0
    got = (d / "port.vcf").read_text()
    assert_vcf_close(got, (d / "jax.vcf").read_text())
    assert len(got.splitlines()) >= 3
    assert info_lines(err) == info_lines(jerr)
    if extra:
        assert "[INFO] full-alignment re-called 1 sites" in err
    assert sum(ln.startswith("VariantCalling execution time:")
               for ln in err.splitlines()) == 1


def test_cli_full_alignment_sites_of_different_coverage(hap_case, weights):
    """Two re-examined sites of 31 and 40 rows (test_variant.py's seed 8):
    JAX's run raises; the port's VCF equals the one JAX's per-site
    functions give (the 31-row tensor zero-padded to the 89-row model's
    depth)."""
    d, ref = hap_case(True)
    extra = ("--full-alignment", "--fa-qual", "100")
    with pytest.raises(ValueError, match="same shape"):
        call(J.run, cli_argv(d, weights, d / "jax.vcf", *extra))
    rc, err = call(port_run, cli_argv(d, weights, d / "port.vcf", *extra))
    assert rc == 0 and "[INFO] full-alignment re-called 2 sites" in err

    jrecs = JB.read_bam(str(d / "x.bam"))[1]
    pc = J.PileupCaller(J.convert_keras_weights(dict(np.load(weights[0]))))
    fc = J.FullAlignmentCaller(J.convert_keras_weights_full(
        dict(np.load(weights[1]))))
    cands = _jax_candidates(*j_pileup(jrecs, 0, 0, 400)[:3], ref, 0.25)
    tensors = np.stack([J.pileup_tensor_from_bam(jrecs, 0, p, ref)
                        for p, _ in cands])
    rows = pc.call_variants(tensors, [p for p, _ in cands],
                            [b for _, b in cands], "c1")
    hets = [(int(r.split("\t")[1]) - 1, r.split("\t")[4]) for r in rows
            if r.split("\t")[9] == "0/1" and len(r.split("\t")[4]) == 1]
    tags = J.phase_hets(jrecs, [h[0] for h in hets], [h[1] for h in hets],
                        0) if hets else {}
    sel = [int(r.split("\t")[1]) - 1 for r in rows]
    fa = [J.full_alignment_tensor(jrecs, 0, p, ref, tags) for p in sel]
    assert sorted(len(t) for t in fa) == [31, 40]
    probs = np.concatenate([fc.predict(np.concatenate(
        [t, np.zeros((89 - len(t), 33, 8), np.int32)])[None]
        if len(t) == 31 else t[None]) for t in fa])
    want = J.merge_vcf_rows(rows, J.rows_from_probs(
        probs, sel, [ref[p] for p in sel], "c1"), {p + 1 for p in sel})
    header = ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
              "FILTER\tINFO\tFORMAT\tSAMPLE"]
    assert_vcf_close((d / "port.vcf").read_text(), "\n".join(header + want))
