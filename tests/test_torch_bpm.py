"""The PyTorch port's bpm path against the JAX package, on the CPU.

Every comparison is exact: distances and scores are integers and no
float enters the DP.  The port runs its plain PyTorch versions here
(CPU tensors); the CUDA kernel is held against the same plain version
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from genarchbench_tpu.io.seqpair_io import read_seqpairs as jax_read
from genarchbench_tpu.kernels import bpm as jbpm
from genarchbench_tpu.kernels.bpm_pallas import bpm_distance_pallas
from genarchbench_tpu_torch.convert import bpm_inputs_from_jax
from genarchbench_tpu_torch.io.seqpair_io import read_seqpairs
from genarchbench_tpu_torch.kernels import bpm, bpm_cuda
from tests.synth import gen_seqpair_dataset

# tests/test_bpm.py's datasets: (seed, pairs, length, error rate)
DATASETS = [
    (0, 50, 100, 0.05),
    (1, 40, 100, 0.30),     # high error rate
    (2, 30, 300, 0.10),     # multi-word patterns
    (3, 20, 20, 0.50),      # short, heavy edits
]


def write_pairs(tmp_path, seed, n, length, err):
    path = tmp_path / "pairs.txt"
    path.write_text(gen_seqpair_dataset(np.random.default_rng(seed),
                                        n_pairs=n, length=length,
                                        error_rate=err))
    return str(path)


def jax_device_calls(monkeypatch, pairs):
    """The (peq, plen, text, tlen, W) arguments and results of every
    `_bpm_distance_device` call that the JAX bpm_batch makes."""
    calls = []
    orig = jbpm._bpm_distance_device

    def record(peq, plen, text, tlen, W):
        out = orig(peq, plen, text, tlen, W)
        calls.append(((np.asarray(peq), np.asarray(plen), np.asarray(text),
                       np.asarray(tlen)), np.asarray(out)))
        return out

    monkeypatch.setattr(jbpm, "_bpm_distance_device", record)
    jbpm.bpm_batch(pairs, backend="xla")
    return calls


@pytest.mark.parametrize("W", [1, 2, 5])
def test_compile_peq_equal(W):
    rng = np.random.default_rng(W)
    pats = [rng.integers(0, 5, int(rng.integers(1, 32 * W + 1))).astype(np.uint8)
            for _ in range(17)]
    np.testing.assert_array_equal(bpm.compile_peq(pats, W),
                                  jbpm.compile_peq(pats, W))


@pytest.mark.parametrize("seed,n,length,err", DATASETS)
def test_plain_matches_xla_device(monkeypatch, tmp_path, seed, n, length, err):
    """The plain version on the JAX package's own DP inputs, converted."""
    pairs = jax_read(write_pairs(tmp_path, seed, n, length, err),
                     swap_longer_first=True)
    calls = jax_device_calls(monkeypatch, pairs)
    assert calls
    for args, want in calls:
        got = bpm_cuda.bpm_distance(*bpm_inputs_from_jax(*args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret(tmp_path):
    """tests/test_bpm.py's Pallas case, the kernel run interpreted."""
    pairs = jax_read(write_pairs(tmp_path, 9, 30, 90, 0.15),
                     swap_longer_first=True)
    for idx, (peq, plen, text, tlen) in bpm.kernel_inputs(pairs):
        W = peq.shape[0]
        jax_peq = peq.view(np.uint32).transpose(2, 0, 1)
        jax_text = text.T.astype(np.int32)
        want = bpm_distance_pallas(jax_peq, plen, jax_text, tlen, W,
                                   interpret=True)
        got = bpm_cuda.bpm_distance(
            *bpm_inputs_from_jax(jax_peq, plen, jax_text, tlen))
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_uint32_edges():
    """A pattern whose last row is bit 31 (the sign bit of an int32),
    an empty text and N codes, against the JAX device function."""
    rng = np.random.default_rng(4)
    pats = [rng.integers(0, 4, m).astype(np.uint8) for m in (64, 33, 63, 50)]
    texts = [rng.integers(0, 5, m).astype(np.uint8) for m in (40, 70, 0, 9)]
    W = 2
    peq = jbpm.compile_peq(pats, W)
    plen = np.array([len(p) for p in pats], np.int32)
    tlen = np.array([len(t) for t in texts], np.int32)
    text = np.zeros((len(pats), 80), np.int32)
    for b, t in enumerate(texts):
        text[b, :len(t)] = t
    want = np.asarray(jbpm._bpm_distance_device(peq, plen, text, tlen, W))
    got = bpm_cuda.bpm_distance(*bpm_inputs_from_jax(peq, plen, text, tlen))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,n,length,err", DATASETS[:2] + [
    (9, 60, None, 0.2)])          # tests/test_bpm.py's mixed lengths
def test_bpm_batch_matches_jax(tmp_path, seed, n, length, err):
    if length is None:
        rng = np.random.default_rng(seed)
        path = tmp_path / "pairs.txt"
        path.write_text("".join(
            gen_seqpair_dataset(rng, n_pairs=10, length=L, error_rate=err)
            for L in (10, 64, 65, 128, 200, 500)))
        path = str(path)
    else:
        path = write_pairs(tmp_path, seed, n, length, err)
    before = bpm_cuda.LAUNCHES
    got = bpm.bpm_batch(read_seqpairs(path, swap_longer_first=True),
                        device="cpu")
    want = jbpm.bpm_batch(jax_read(path, swap_longer_first=True),
                          backend="xla")
    np.testing.assert_array_equal(got, want)
    assert bpm_cuda.LAUNCHES == before      # CPU tensors launch no kernel


@pytest.mark.parametrize("alg,seed,n,length,err", [
    ("bitpal-edit", 0, 32, 100, 0.1),
    ("bitpal-edit", 1, 24, 300, 0.25),
    ("bitpal-scored", 2, 32, 100, 0.1),
    ("bitpal-scored", 3, 24, 300, 0.25),
])
def test_bitpal_batch_matches_jax(tmp_path, alg, seed, n, length, err):
    sc = (0, -1, -1) if alg == "bitpal-edit" else (1, -4, -2)
    path = write_pairs(tmp_path, seed, n, length, err)
    got = bpm.bitpal_batch(read_seqpairs(path, swap_longer_first=True), *sc,
                           device="cpu")
    want = jbpm.bitpal_batch(jax_read(path, swap_longer_first=True), *sc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alg", ["bpm-edit", "bitpal-scored"])
def test_run_output_matches_jax(monkeypatch, tmp_path, alg):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    path = write_pairs(tmp_path, 2, 30, 300, 0.10)
    ours, theirs = tmp_path / "torch.out", tmp_path / "jax.out"
    assert bpm.run(["-a", alg, "-i", path, "-o", str(ours)]) == 0
    assert jbpm.run(["-a", alg, "-i", path, "-o", str(theirs)]) == 0
    assert (sorted(ours.read_text().splitlines())
            == sorted(theirs.read_text().splitlines()))
