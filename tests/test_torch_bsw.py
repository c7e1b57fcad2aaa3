"""The PyTorch port's bsw path against the JAX package, on the CPU.

Every comparison is exact: the six DP outputs are integers and no float
enters the DP.  The port runs its plain PyTorch version here (CPU
tensors); the CUDA kernel is held against the same plain version on the
card by chip_smoke.py.
"""

import re

import numpy as np
import pytest

from genarchbench_tpu.io.bsw_io import read_bsw_pairs as jax_read
from genarchbench_tpu.kernels import bsw as jbsw
from genarchbench_tpu.kernels.bsw_pallas import _bsw_pallas
from genarchbench_tpu_torch.convert import bsw_inputs_from_jax
from genarchbench_tpu_torch.io.bsw_io import read_bsw_pairs
from genarchbench_tpu_torch.kernels import bsw, bsw_cuda
from tests.synth import gen_bsw_input

# the default scoring of bsw_batch, with the signed scores of fill_scmat
SCORING = dict(match=1, mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
               e_ins=1, zdrop=100, w=100)


def write_pairs(tmp_path, seed, n, rlen, qlen, err=0.1, ambig=0.0):
    """A synth bsw input; with `ambig`, that share of bases becomes '4'."""
    rng = np.random.default_rng(seed)
    text = gen_bsw_input(rng, n_pairs=n, ref_len=rlen, query_len=qlen,
                         error_rate=err)
    if ambig:
        lines = text.splitlines()
        for k in range(len(lines)):
            if k % 3:
                s = np.frombuffer(lines[k].encode(), np.uint8).copy()
                s[rng.random(len(s)) < ambig] = ord("4")
                lines[k] = s.tobytes().decode()
        text = "\n".join(lines) + "\n"
    path = tmp_path / "pairs.txt"
    path.write_text(text)
    return str(path)


def jax_device_calls(monkeypatch, pairs, **kw):
    """The DP inputs and the six outputs of every `_bsw_device` call that
    the JAX bsw_batch makes."""
    calls = []
    orig = jbsw._bsw_device

    def record(*args, **static):
        out = orig(*args, **static)
        calls.append((tuple(np.asarray(a) for a in args),
                      tuple(np.asarray(o) for o in out), static))
        return out

    monkeypatch.setattr(jbsw, "_bsw_device", record)
    jbsw.bsw_batch(pairs, backend="xla", **kw)
    return calls


@pytest.mark.parametrize("seed,n,rlen,qlen,ambig,batch,lanes,kw", [
    (0, 64, 200, 100, 0.0, 512, 8, {}),
    (5, 64, 250, 100, 0.05, 16, 8, {}),   # small batches, ambiguous bases
    (10, 64, 100, 80, 0.0, 512, 16, {}),  # the -i8 group width
    (6, 32, 300, 250, 0.0, 512, 8,        # a band narrower than the query
     dict(w=10, zdrop=20)),
])
def test_plain_matches_xla_device(monkeypatch, tmp_path, seed, n, rlen, qlen,
                                  ambig, batch, lanes, kw):
    """All six outputs of the plain version on the JAX package's own DP
    inputs, converted."""
    pairs = jax_read(write_pairs(tmp_path, seed, n, rlen, qlen, err=0.3,
                                 ambig=ambig))
    calls = jax_device_calls(monkeypatch, pairs, batch_size=batch,
                             lanes=lanes, **kw)
    assert calls
    for args, want, static in calls:
        assert static["R"] == 2 * args[0].shape[2]
        got = bsw_cuda.bsw_scores(*bsw_inputs_from_jax(*args),
                                  **{**SCORING, **kw})
        assert len(got) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_plain_matches_pallas_interpret(monkeypatch, tmp_path):
    """tests/test_bsw.py's Pallas case, the kernel run interpreted on the
    JAX package's DP inputs."""
    pairs = jax_read(write_pairs(tmp_path, 77, 24, 110, 80))
    for args, _, static in jax_device_calls(monkeypatch, pairs):
        want = _bsw_pallas(*args, **static, interpret=True)
        got = bsw_cuda.bsw_scores(*bsw_inputs_from_jax(*args), **SCORING)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_inputs_hold_the_jax_groups(monkeypatch, tmp_path):
    """The port's one-call inputs put every pair in the group the JAX
    package's per-bucket calls put it in, with the same lane data."""
    path = write_pairs(tmp_path, 1, 128, 300, 120, err=0.25)
    calls = jax_device_calls(monkeypatch, jax_read(path), batch_size=16)
    src, (s1, s2, l1, l2, h0, mb) = bsw.kernel_inputs(
        read_bsw_pairs(path), 16, bsw.LANES, match=1, end_bonus=5, o_ins=6,
        e_ins=1, o_del=6, e_del=1, w=100)
    port = {tuple(l1[g]) + tuple(l2[g]) + tuple(h0[g]) + tuple(mb[g])
            for g in range(len(src))}
    jax_groups = {tuple(a[2][g]) + tuple(a[3][g]) + tuple(a[4][g])
                  + tuple(a[5][g])
                  for a, _, _ in calls for g in range(a[2].shape[0])}
    assert port == jax_groups


@pytest.mark.parametrize("seed,n,rlen,qlen,err,batch,lanes,kw", [
    (0, 64, 200, 100, 0.10, 512, 8, {}),
    (1, 128, 300, 120, 0.25, 512, 8, {}),
    (2, 48, 120, 100, 0.05, 512, 8, {}),
    (5, 64, 250, 100, 0.15, 16, 8, {}),     # per-batch sort and grouping
    (10, 64, 100, 80, 0.05, 512, 16, {}),   # -i8 grouping
    (11, 96, 120, 90, 0.05, 512, 16, {}),
    (6, 64, 200, 150, 0.40, 512, 8,         # z-drop exits, a narrow band
     dict(zdrop=8, w=30, mismatch=2)),
])
def test_bsw_batch_matches_jax(tmp_path, seed, n, rlen, qlen, err, batch,
                               lanes, kw):
    path = write_pairs(tmp_path, seed, n, rlen, qlen, err=err)
    before = bsw_cuda.LAUNCHES
    got = bsw.bsw_batch(read_bsw_pairs(path), batch_size=batch, lanes=lanes,
                        device="cpu", **kw)
    want = jbsw.bsw_batch(jax_read(path), batch_size=batch, lanes=lanes,
                          **kw)
    np.testing.assert_array_equal(got, want)
    assert bsw_cuda.LAUNCHES == before      # CPU tensors launch no kernel


def score_lines(text):
    return [ln for ln in text.splitlines() if re.match(r"\[\d+\] score=", ln)]


@pytest.mark.parametrize("extra", [[], ["-b", "16"], ["-i8"]])
def test_run_score_lines_match_jax(monkeypatch, capsys, tmp_path, extra):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    # lengths and seed scores inside -i8's range (h0 < 50, lengths < 70)
    path = write_pairs(tmp_path, 3, 40, 70, 50, ambig=0.02)
    assert bsw.run(["-pairs", path, *extra]) == 0
    ours = capsys.readouterr()
    assert jbsw.run(["-pairs", path, *extra]) == 0
    theirs = capsys.readouterr()
    assert score_lines(ours.err) == score_lines(theirs.err)
    assert len(score_lines(ours.err)) == 40
    assert "Overall SW cycles = 0, " in ours.out
    assert "Total Pairs processed: 40" in ours.out


def test_run_i8_refuses_long_input(monkeypatch, tmp_path):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    path = write_pairs(tmp_path, 4, 8, 200, 100)
    with pytest.raises(ValueError, match="int8 kernel's range"):
        bsw.run(["-pairs", path, "-i8"])
