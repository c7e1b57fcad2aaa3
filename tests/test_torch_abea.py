"""The port's abea device path against the JAX package, on the CPU.

The JAX calls run under `jax.enable_x64()`, as the JAX `align_batch`
makes them; inputs come from a seeded synthetic pore model
(tests/torch_abea_inputs.py).  Held exactly: the bands (bitwise, -inf
included), traces, band positions and every backtrace output, the pair
lists of `align_batch`, and the CLI's TSV on both signal routes.  The
JAX band scan and backtrace are compiled with XLA's backend optimization
level 0 (`AS_WRITTEN`): at its default level, XLA's CPU build drops one
f32 rounding that the JAX source writes (the product -0.5 * a * a inside
the emission's final sum, `test_emission_rounding`), which moves band
values by a few ulps on squiggle events; the port rounds as the source
and the reference do.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genarchbench_tpu.io import bam_io as JB
from genarchbench_tpu.kernels import abea as J
from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.io import bam_io as TB
from genarchbench_tpu_torch.io import fast5_io as TF
from genarchbench_tpu_torch.kernels import abea as T
from tests import torch_abea_inputs as I

MODEL = I.synth_model(0)
ARGS = ("ranks", "ev_mean", "n_ev", "n_km", "shifts", "scales", "lm", "lsd",
        "llsd")
BT_OUT = ("fr_out", "e0", "n_al", "sum_em", "mgap", "k_last")
AS_WRITTEN = {"xla_backend_optimization_level": 0}


def as_written(fn, *args, **static):
    """The jitted JAX function `fn` compiled at XLA's backend optimization
    level 0, which keeps every f32 rounding its source writes, and called
    on args."""
    return fn.lower(*args, **static).compile(
        compiler_options=AS_WRITTEN)(*args)


def squiggle_batch(seed, lengths, model=MODEL):
    rng = np.random.default_rng(seed)
    seqs = [I.random_seq(rng, n) for n in lengths]
    ets = [T.get_events(I.synth_signal(rng, model, s)) for s in seqs]
    return seqs, ets


class Case:
    """One batch's host arrays, its JAX band scan and backtrace, and the
    port's band scan (the JAX package's own functions and arguments)."""

    def __init__(self, host, NB, NE, NK):
        self.host, self.NB, self.NE, self.NK = host, NB, NE, NK
        with jax.enable_x64():
            jh = [jnp.asarray(host[k]) for k in ARGS]
            jl = [jnp.asarray(x) for x in host["lps"]]
            jb = as_written(J._band_scan_device, *jh, *jl, NB=NB, NE=NE,
                            NK=NK)
            self.jax_band = [np.asarray(x) for x in jb]
            self.jax_bt = [np.asarray(x) for x in as_written(
                J._abea_backtrace_device, *jb, *jh, jl[3], NB=NB, NE=NE,
                NK=NK, T=NB)]
        self.th = [torch.from_numpy(host[k]) for k in ARGS]
        self.tl = list(torch.from_numpy(host["lps"]))
        self.band = T.band_scan(*self.th, *self.tl, NB, NE, NK)

    def backtrace(self, band):
        return T.backtrace(*band, *self.th, self.tl[3], self.NB, self.NE,
                           self.NK, self.NB)


@pytest.fixture(scope="module")
def batch4():
    """4 reads of 150-270 bases (test_abea.py:121-133's shapes)."""
    seqs, ets = squiggle_batch(6, [150 + 40 * i for i in range(4)])
    case = Case(*T._host_inputs(seqs, ets, MODEL))
    case.seqs, case.ets = seqs, ets
    return case


def assert_bt_equal(got, want, what):
    for name, g, w in zip(BT_OUT, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.array_equal(g, w), f"{what}: {name} differs"


@pytest.mark.parametrize("ties", [False, True], ids=["dyadic", "ties"])
def test_band_scan_exact(ties):
    """Bands (bitwise, -inf included), traces and band positions exact,
    and the backtrace over them."""
    host, NB, NE, NK = I.dyadic_host(np.random.default_rng(7),
                                     [90, 200, 150, 31], ties)
    c = Case(host, NB, NE, NK)
    for name, got, want in zip(("bands", "traces", "blls"), c.band,
                               c.jax_band):
        assert got.shape == want.shape
        assert got.numpy().tobytes() == want.tobytes(), name
    traces = c.band[1].numpy()
    if ties:   # the L > U > D order decided cells where scores were equal
        assert (traces == 1).sum() > 1000 and (traces == 2).sum() > 1000
    assert_bt_equal(c.backtrace(c.band), c.jax_bt, "backtrace")


def test_band_scan_on_events(batch4):
    """Bands bitwise, traces and band positions exact on event tables from
    squiggles, where the emission's roundings matter."""
    for name, got, want in zip(("bands", "traces", "blls"), batch4.band,
                               batch4.jax_band):
        assert got.numpy().tobytes() == want.tobytes(), name


def test_emission_rounding():
    """The port's emission rounds -0.5 * a * a to float32 before the sum,
    as abea.py:375-379 writes it (numpy below, op for op), and so does
    that expression compiled by XLA at backend optimization level 0.  At
    XLA's default level the CPU build keeps the product in float64 (its
    HLO still holds both converts): shown where that holds."""
    rng = np.random.default_rng(0)
    n = 20000
    em = rng.uniform(60, 130, n).astype(np.float32)
    gpm = (em + rng.normal(0, 3, n)).astype(np.float32)
    gps = rng.uniform(1, 3, n).astype(np.float32)
    t1 = rng.uniform(-2, -1, n).astype(np.float32)
    c64 = lambda v: v.astype(np.float64)
    a = (c64(em - gpm) / c64(gps)).astype(np.float32)
    t2 = (np.float64(-0.5) * c64(a)).astype(np.float32)
    t2_f64 = c64(t2) * c64(a)
    rounded = (c64(t1) + c64(t2_f64.astype(np.float32))).astype(np.float32)
    unrounded = (c64(t1) + t2_f64).astype(np.float32)
    got = T._emission(*(torch.from_numpy(x) for x in (em, gpm, gps, t1)))
    np.testing.assert_array_equal(got.numpy(), rounded)

    with jax.enable_x64():
        c32, j64 = (lambda v: v.astype(jnp.float32)), \
            (lambda v: v.astype(jnp.float64))

        @jax.jit
        def xla(em, gpm, gps, t1):
            a = c32(j64(em - gpm) / gps)
            t2 = c32(j64(jnp.float32(-0.5)) * j64(a))
            t2 = c32(j64(t2) * j64(a))
            return c32(j64(t1) + j64(t2))

        jax_lp = np.asarray(xla(em, gpm, gps, t1))
        np.testing.assert_array_equal(
            np.asarray(as_written(xla, em, gpm, gps, t1)), rounded)
    differ = int((rounded != unrounded).sum())
    assert differ > n // 50
    if not np.array_equal(jax_lp, rounded):
        np.testing.assert_array_equal(jax_lp, unrounded)


def test_backtrace(batch4):
    """The port's backtrace over the JAX bands, and over its own, against
    the JAX backtrace: every output exact."""
    jband = [torch.tensor(x) for x in batch4.jax_band]
    assert_bt_equal(batch4.backtrace(jband), batch4.jax_bt, "on JAX's bands")
    got = batch4.backtrace(batch4.band)
    assert_bt_equal(got, batch4.jax_bt, "on the port's bands")
    assert (got[0][:, :int(got[2].max())] != 255).any()


def test_backtrace_against_host_walk(batch4):
    h = batch4.host
    fr_out, e0, n_al, sum_em, mgap, k_last = (
        x.numpy() for x in batch4.backtrace(batch4.band))
    pairs = T._pairs(fr_out, e0, n_al, sum_em, mgap, k_last, h["n_km"])
    bands, traces, blls = (x.numpy() for x in batch4.band)
    for i, seq in enumerate(batch4.seqs):
        want = T.backtrace_one(
            bands[:, i], traces[:, i], blls[:, i], int(h["n_ev"][i]),
            int(h["n_km"][i]), seq, h["ev_mean"][i], MODEL, h["shifts"][i],
            h["scales"][i], tuple(h["lps"][:, i]))
        assert pairs[i] == want and want


@pytest.mark.parametrize("block", [7, 700], ids=["ragged", "block-past-NB"])
def test_block_runner(batch4, block):
    """Blocks of 7 steps (NB - 2 not a multiple of 7) and one block longer
    than NB give the BLOCK-step blocks' outputs; the padding slots and the
    backtrace's spare column leave the result untouched."""
    NB = batch4.NB
    assert (NB - 2) % block
    counts = {}
    full = T._band_scan(*batch4.th, *batch4.tl, NB, block, False, counts)
    assert full[0].shape[0] == T.padded_bands(NB, block) > NB
    assert counts == dict(band_steps=NB - 2,
                          band_blocks=-(-(NB - 2) // block))
    band = [x[:NB] for x in full]
    for got, want in zip(band, batch4.band):
        assert torch.equal(got, want)
    bt = T._backtrace(*full, *batch4.th, batch4.tl[3], NB, NB, block, False,
                      counts)
    assert counts["bt_steps"] == counts["bt_blocks"] * block
    assert counts["bt_steps"] >= int(bt[2].max())
    assert bt[0].shape == (4, NB)
    assert_bt_equal(bt, batch4.jax_bt, f"block {block}")


CASES = {
    "one-200": (3, [200]), "one-400": (4, [400]), "one-300": (5, [300]),
    "mixed": (7, [10, 45, 120, 700, 333]),
}


@pytest.mark.parametrize("name", [*CASES, "qc-fail"])
def test_align_batch(name):
    if name == "qc-fail":
        # read 1's signal belongs to another sequence: its mean emission
        # is far below -5, so QC empties it
        seqs, ets = squiggle_batch(8, [220, 260, 180])
        rng = np.random.default_rng(9)
        ets[1] = T.get_events(I.synth_signal(rng, MODEL,
                                             I.random_seq(rng, 260)))
    else:
        seqs, ets = squiggle_batch(*CASES[name])
    stats = {}
    got = T.align_batch(seqs, ets, MODEL, device="cpu", stats=stats)
    with jax.enable_x64():
        want = J.align_batch(seqs, ets, MODEL)
    assert got == want
    assert [bool(p) for p in got] == ([True, False, True] if name == "qc-fail"
                                      else [True] * len(seqs))
    NB = stats["nb"]
    assert NB == max(len(e) + len(s) - 5 for s, e in zip(seqs, ets)) + 2
    assert stats["band_blocks"] == -(-(NB - 2) // T.BLOCK)
    assert stats["graphed"] is False
    for k in ("prep_s", "h2d_s", "band_s", "backtrace_s", "d2h_s", "pairs_s"):
        assert stats[k] >= 0


def stdout_of(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """Six reads on one contig (one unmapped), both signal routes, and
    the JAX package's TSV from the .npy route."""
    d = tmp_path_factory.mktemp("abea_cli")
    rng = np.random.default_rng(11)
    seqs = [I.random_seq(rng, int(n)) for n in rng.integers(150, 280, 6)]
    sigs = [I.synth_signal(rng, MODEL, s) for s in seqs]
    paths = I.write_cli_case(d, MODEL, seqs, sigs, TB, TF, gap=40, rng=rng,
                             unmapped={4})
    out = d / "jax.tsv"
    with jax.enable_x64():
        J.run(["-b", str(paths["bam"]), "-g", str(paths["ref"]), "-r",
               str(paths["npy"]), "--kmer-model", str(paths["model"]),
               "-o", str(out), "-K", "3"])
    return paths, out.read_text()


@pytest.mark.parametrize("route", ["npy", "reads"], ids=["npy", "fast5"])
def test_cli_matches_jax(cli_case, tmp_path, monkeypatch, capsys, route):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    paths, want = cli_case
    out = tmp_path / "port.tsv"
    assert cli.main(["run", "abea", "-b", str(paths["bam"]), "-g",
                     str(paths["ref"]), "-r", str(paths[route]),
                     "--kmer-model", str(paths["model"]), "-o", str(out),
                     "-K", "3"]) == 0
    assert out.read_text() == want
    rows = want.splitlines()[1:]
    assert len(rows) > 500 and {r.split("\t")[3] for r in rows} == \
        {"0", "1", "2", "3", "5"}
    assert "Data processing time: " in capsys.readouterr().err
    # the BAM the case wrote reads the same through the JAX reader
    assert [r.qname for r in JB.read_bam(str(paths["bam"]))[1]] == \
        [f"r{i}" for i in range(6)]


def test_cli_to_stdout(cli_case, monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    paths, want = cli_case
    got = stdout_of(T.run, ["-b", str(paths["bam"]), "-g", str(paths["ref"]),
                            "-r", str(paths["reads"]) + ".index.readdb",
                            "--kmer-model", str(paths["model"])])
    assert got == want


def test_write_eventalign(batch4):
    """The column-wise writer against the JAX package's row loop, on the
    batch's pairs and on pairs past the last k-mer (k-mer rank 0)."""
    seqs, ets = list(batch4.seqs), list(batch4.ets)
    pairs = T.align_batch(seqs, ets, MODEL, device="cpu")
    pairs.append([(0, 0), (len(seqs[0]) - 6, 3), (len(seqs[0]) - 3, 1)])
    seqs.append(seqs[0])
    ets.append(ets[0])
    for i, (seq, et, pr) in enumerate(zip(seqs, ets, pairs)):
        sh, sc = T.estimate_scalings(seq, et, MODEL)
        got, want = io.StringIO(), io.StringIO()
        T.write_eventalign(got, "tig1", 1000 * i, seq, pr, et, MODEL, sh, sc,
                           i)
        J.write_eventalign(want, "tig1", 1000 * i, seq, pr, et, MODEL, sh,
                           sc, i)
        assert got.getvalue() == want.getvalue()
        assert got.getvalue().count("\n") == len(pr)
    got = io.StringIO()
    T.write_eventalign(got, "tig1", 0, seqs[0], [], ets[0], MODEL, sh, sc, 0)
    assert got.getvalue() == ""
