"""abea's host half in the port against the JAX package, on the CPU.

The pore-model reader in its three file forms, k-mer ranks, the
t-statistics, the C peak finder against its plain Python version and the
JAX package's C, event detection (test_abea.py's signals and a
bench-shaped squiggle) and the scaling estimate, all exact.
"""

import numpy as np
import pytest

from genarchbench_tpu import native as jax_native
from genarchbench_tpu.kernels import abea as J
from genarchbench_tpu_torch import native
from genarchbench_tpu_torch.kernels import abea as T
from tests import torch_abea_inputs as I

MODEL = I.synth_model(0)


@pytest.mark.parametrize("form", I.MODEL_FORMS)
def test_load_model(tmp_path, form):
    path = tmp_path / "m.txt"
    I.write_model(path, MODEL, form)
    got, want = T.load_model(str(path)), J.load_model(str(path))
    assert sorted(got) == sorted(want) == sorted(MODEL)
    for k in MODEL:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], MODEL[k])


def test_load_model_refuses_a_short_table(tmp_path):
    path = tmp_path / "m.txt"
    path.write_text("#header\n90.5 1.5\n91.0 1.25\n")
    with pytest.raises(ValueError, match="2 entries, want 4096"):
        T.load_model(str(path))


@pytest.mark.parametrize("seq", ["ACGTAC", "ACGTN" * 9, "ACG", "",
                                 I.random_seq(np.random.default_rng(0), 300)])
def test_kmer_ranks(seq):
    got = T.kmer_ranks(seq)
    np.testing.assert_array_equal(got, J.kmer_ranks(seq))
    assert got.dtype == np.int64
    if "N" not in seq:
        np.testing.assert_array_equal(got, I.kmer_ranks(seq))


def cumsums(raw):
    raw = raw.astype(np.float32)
    sums = np.zeros(len(raw) + 1, np.float64)
    sumsqs = np.zeros(len(raw) + 1, np.float64)
    np.cumsum(raw.astype(np.float64), out=sums[1:])
    np.cumsum((raw * raw).astype(np.float64), out=sumsqs[1:])
    return sums, sumsqs


@pytest.mark.parametrize("n,w", [(5, 3), (11, 6), (12, 6), (700, 3),
                                 (700, 6), (40, 1)])
def test_compute_tstat(n, w):
    """n < 2w and w < 2 give zeros; otherwise the C float semantics."""
    raw = np.random.default_rng(n).normal(90, 8, n).astype(np.float32)
    sums, sumsqs = cumsums(raw)
    got = T.compute_tstat(sums, sumsqs, n, w)
    np.testing.assert_array_equal(got, J.compute_tstat(sums, sumsqs, n, w))
    assert got.dtype == np.float32
    assert got.any() == (n >= 2 * w and w >= 2)


def stepped_signal(seed, nsamp):
    """tests/test_abea.py:83-89's signal: 60 levels, 10-39 samples each."""
    rng = np.random.default_rng(seed)
    lv = rng.normal(90, 10, 60)
    reps = rng.integers(10, 40, 60)
    return (np.repeat(lv, reps) + rng.normal(0, 1.2, int(reps.sum()))
            ).astype(np.float32)[:nsamp]


SIGNALS = {
    "steps-2000": lambda: stepped_signal(0, 2000),
    "steps-5000": lambda: stepped_signal(1, 5000),
    "bench-read": lambda: I.bench_input(MODEL, n_reads=1)[1][0],
    "short": lambda: np.array([90.0, 91.0, 150.0, 89.0, 92.0], np.float32),
    "flat": lambda: np.full(300, 80.0, np.float32),
}


@pytest.mark.parametrize("name", SIGNALS)
def test_peak_detect(name):
    raw = SIGNALS[name]()
    sums, sumsqs = cumsums(raw)
    t1 = T.compute_tstat(sums, sumsqs, len(raw), T.WIN1)
    t2 = T.compute_tstat(sums, sumsqs, len(raw), T.WIN2)
    got = native.peak_detect(t1, t2, T.THRESH1, T.THRESH2, T.WIN1, T.WIN2,
                             T.PEAK_HEIGHT)
    plain = T._peak_detect(t1, t2)
    np.testing.assert_array_equal(plain[:len(got)], got)
    assert not plain[len(got):].any()
    out, pc = jax_native.peak_detect_native(t1, t2, T.THRESH1, T.THRESH2,
                                            T.WIN1, T.WIN2, T.PEAK_HEIGHT)
    np.testing.assert_array_equal(out[:pc], got)
    if name.startswith(("steps", "bench")):
        assert len(got) > 20


def test_peak_detect_checks_shapes():
    with pytest.raises(ValueError, match="one 1-D shape"):
        native.peak_detect(np.zeros(5), np.zeros(6), 1.4, 9.0, 3, 6, 0.2)


@pytest.mark.parametrize("name", SIGNALS)
def test_get_events(name):
    raw = SIGNALS[name]()
    got = T.get_events(raw)
    np.testing.assert_array_equal(got, J.get_events(raw))
    assert got.dtype == np.float64 and got.shape[1] == 4
    assert got[:, 1].sum() == len(raw)


def test_estimate_scalings():
    rng = np.random.default_rng(2)
    for n in (30, 300, 2000):
        seq = I.random_seq(rng, n)
        et = T.get_events(I.synth_signal(rng, MODEL, seq))
        got = T.estimate_scalings(seq, et, MODEL)
        want = J.estimate_scalings(seq, et, MODEL)
        assert [type(v) for v in got] == [np.float32, np.float32]
        assert got == want
