"""The PyTorch port's nn-base path against the JAX package, on the CPU,
at tests/test_basecall.py's TINY config.

The forward pass is float32 in both frameworks with the sums taken in
other orders, so log-probabilities are compared with test_basecall.py's
atol 2e-4; the host functions are the same numpy code and compare
exactly, as do the CLI's FASTA and FASTQ on these seeds.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from genarchbench_tpu.nn import basecall as jbc
from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.convert import basecall_state_from_jax
from genarchbench_tpu_torch.entry import entry
from genarchbench_tpu_torch.nn import basecall as bc
from tests.test_basecall import TINY, _torch_quartznet

TINY_TOML = """\
[input]
features = 1

[encoder]
activation = "swish"

[labels]
labels = ["N", "A", "C", "G", "T"]

[[block]]
filters = 8
repeat = 1
kernel = [9]
stride = [3]
dilation = [1]
dropout = 0.0
residual = false
separable = false

[[block]]
filters = 12
repeat = 3
kernel = [7]
stride = [1]
dilation = [1]
dropout = 0.0
residual = true
separable = true

[[block]]
filters = 16
repeat = 1
kernel = [1]
stride = [1]
dilation = [1]
dropout = 0.0
residual = false
separable = false
"""


def jax_variables(seed, random_stats):
    """The JAX Basecaller.init variables as nested dicts of numpy arrays,
    with BatchNorm statistics and affine terms drawn from `seed` when
    `random_stats` (so the BN terms are exercised, not the identity)."""
    caller = jbc.Basecaller.init(TINY, seed=seed, chunksize=120)
    var = jax.tree.map(np.asarray, caller.variables)
    var = {k: jax.tree.map(np.array, dict(v)) for k, v in var.items()}
    if random_stats:
        rng = np.random.default_rng(seed)

        def perturb(tree, kind):
            for k, v in tree.items():
                if isinstance(v, dict):
                    perturb(v, kind)
                elif kind == "stats":
                    tree[k] = (rng.uniform(0.5, 2.0, v.shape) if k == "var"
                               else rng.normal(0, 0.5, v.shape)
                               ).astype(np.float32)
                elif k in ("scale", "bias") and v.ndim == 1:
                    tree[k] = (v + rng.normal(0, 0.2, v.shape)
                               ).astype(np.float32)

        perturb(var["batch_stats"], "stats")
        perturb(var["params"], "params")
    return var


@pytest.mark.parametrize("random_stats", [False, True])
def test_forward_matches_jax(random_stats):
    var = jax_variables(1, random_stats)
    want = jbc.Basecaller(TINY, jax.tree.map(np.asarray, var))
    model = bc.BasecallModel(TINY)
    model.load_state_dict(basecall_state_from_jax(var, TINY), strict=True)
    caller = bc.Basecaller(TINY, model, device="cpu")
    x = np.random.default_rng(0).normal(size=(3, 120, 1)).astype(np.float32)
    got = caller.forward(x)
    assert got.shape == (3, 40, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.forward(x), atol=2e-4)


def bonito_dir(tmp_path, seed=0, center_on=None):
    """A bonito model directory for TINY: config.toml and weights_0.tar,
    the state dict of test_basecall.py's independently built torch model
    with random BatchNorm terms.  With `center_on` (a normalized signal)
    the decoder bias is shifted so that each class's mean logit over it
    is 0: a random model otherwise gives one class every frame's argmax,
    and the greedy decoder emits a single base a read."""
    torch.manual_seed(seed)
    tm = _torch_quartznet(TINY).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
                m.weight.normal_(1, 0.2)
                m.bias.normal_(0, 0.2)
        if center_on is not None:
            x = torch.from_numpy(center_on)[None, None]
            logits = tm.decoder.layers(tm.encoder.encoder(x))
            tm.decoder.layers[0].bias -= logits.mean((0, 2))
    d = tmp_path / "model"
    d.mkdir()
    (d / "config.toml").write_text(TINY_TOML)
    torch.save(tm.state_dict(), d / "weights_0.tar")
    return d, tm


def test_bonito_checkpoint_loads_without_conversion(tmp_path):
    d, tm = bonito_dir(tmp_path)
    caller = bc.load_torch_checkpoint(str(d), device="cpu")
    assert caller.config["block"] == TINY["block"]
    assert not caller.model.training
    x = np.random.default_rng(5).normal(size=(2, 150, 1)).astype(np.float32)
    with torch.no_grad():
        theirs = tm(torch.from_numpy(x.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(caller.forward(x), theirs, atol=1e-6)
    jcaller = jbc.load_torch_checkpoint(str(d))
    np.testing.assert_allclose(caller.forward(x), jcaller.forward(x),
                               atol=2e-4)


def test_init_is_seeded():
    a = bc.Basecaller.init(TINY, seed=3, device="cpu").model.state_dict()
    b = bc.Basecaller.init(TINY, seed=3, device="cpu").model.state_dict()
    c = bc.Basecaller.init(TINY, seed=4, device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.layers.0.weight"],
                           c["decoder.layers.0.weight"])
    assert set(a) == set(basecall_state_from_jax(jax_variables(0, False),
                                                 TINY))


def signal(seed, n=1000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 1, n // 2), rng.normal(5, 10, n // 5),
                           rng.normal(0, 1, n - n // 2 - n // 5)])


def posteriors(seed, T=12, C=5):
    return np.random.default_rng(seed).dirichlet(np.ones(C), size=T)


HOST_CASES = {
    "med_mad": lambda m: m.med_mad(signal(0)),
    "norm_by_noisiest_section": lambda m: m.norm_by_noisiest_section(
        signal(1)),
    "norm_int16": lambda m: m.norm_by_noisiest_section(
        (signal(2) * 40 + 400).astype(np.int16)),
    "chunk_signal": lambda m: m.chunk_signal(signal(3).astype(np.float32),
                                             300, 60),
    "chunk_signal_short": lambda m: m.chunk_signal(signal(3)[:100], 300, 60),
    "stitch_predictions": lambda m: m.stitch_predictions(
        np.random.default_rng(4).normal(size=(4, 100, 5)), 10),
    "viterbi_decode": lambda m: m.viterbi_decode(posteriors(5, 40), "NACGT"),
    "viterbi_decode_q": lambda m: m.viterbi_decode(posteriors(6, 40),
                                                   "NACGT", qscores=True),
    "beam_search_decode": lambda m: m.beam_search_decode(posteriors(7, 30),
                                                         "NACGT"),
    "beam_search_decode_wide": lambda m: m.beam_search_decode(
        posteriors(8, 8, 4), "NACG", beamsize=32, threshold=0.0),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_functions_equal(case):
    got, want = HOST_CASES[case](bc), HOST_CASES[case](jbc)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def reads_dir(tmp_path, n=3, samples=2400):
    """n int16 squiggle-like reads: a level every 8 samples, plus noise."""
    d = tmp_path / "reads"
    d.mkdir()
    rng = np.random.default_rng(21)
    for i in range(n):
        m = samples + 300 * i
        levels = np.repeat(rng.normal(400, 80, m // 8 + 1), 8)[:m]
        np.save(d / f"read_{i}.npy",
                (levels + rng.normal(0, 10, m)).astype(np.int16))
    return d


@pytest.mark.parametrize("extra", [[], ["--fastq"]], ids=["fasta", "fastq"])
def test_cli_matches_jax_run(tmp_path, monkeypatch, extra):
    """`GENARCH_DEVICE=cpu cli run nn-base <model> <reads>` writes the JAX
    run's FASTA (beam search) or FASTQ (viterbi with qscores)."""
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    reads = reads_dir(tmp_path)
    d, _ = bonito_dir(tmp_path, seed=2, center_on=bc.norm_by_noisiest_section(
        np.load(reads / "read_0.npy")))
    argv = [str(d), str(reads), "--chunksize", "600", "--overlap", "60",
            *extra]

    def call(fn):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert fn(argv) == 0
        return out.getvalue(), err.getvalue()

    want, _ = call(jbc.run)
    got, err = call(lambda a: cli.main(["run", "nn-base", *a]))
    assert got == want
    records = got.splitlines()[::4 if extra else 2]
    assert [r[1:] for r in records] == ["read_0", "read_1", "read_2"]
    assert min(len(s) for s in got.splitlines()[1::4 if extra else 2]) > 40
    assert "> completed reads: 3" in err
    assert "> samples per second " in err


def test_entry_is_the_default_model():
    fn, (x,) = entry(device="cpu")
    assert isinstance(fn, bc.BasecallModel) and not fn.training
    assert x.shape == (4, 1, 3000) and x.dtype == torch.float32
    assert x.device == torch.device("cpu")
    assert len(fn.encoder.encoder) == len(bc.DEFAULT_CONFIG["block"])
    with torch.no_grad():
        out = fn(x[:1, :, :300])
    assert out.shape == (1, 100, 5)
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
