"""The PyTorch port's bsw path against the JAX package, on the CPU.

Every comparison is exact: the six DP outputs are integers and no float
enters the DP.  The port runs its plain PyTorch version here (CPU
tensors); the CUDA kernel is held against the same plain version on the
card by chip_smoke.py.
"""

import re

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("seed,G,L,R", [(0, 1, 8, 64), (1, 37, 8, 384),
                                        (2, 64, 16, 96), (3, 50, 8, 40)])
def test_group_order_longest_first(seed, G, L, R):
    """Blocks take the groups by descending row count (the longest
    reference of the group, at most R), ties in group order."""
    rng = np.random.default_rng(seed)
    len1 = rng.integers(0, R + 30, (G, L)).astype(np.int32)
    len1[::3] = len1[0]                      # ties
    order = bsw_cuda.group_order(torch.from_numpy(len1), R)
    assert order.dtype == torch.int32 and order.shape == (G,)
    order = order.numpy()
    assert sorted(order) == list(range(G))
    rows = np.minimum(len1.max(axis=1), R)[order]
    assert (np.diff(rows) <= 0).all()
    for r in np.unique(rows):
        tied = order[rows == r]
        assert (np.diff(tied) > 0).all()


@pytest.mark.parametrize("L,C2,K", [(8, 1, 1), (8, 32, 1), (8, 33, 2),
                                    (16, 64, 2), (8, 192, 6), (8, 256, 8),
                                    (32, 256, 8)])
def test_kernel_variant_registers(L, C2, K):
    """Rows of up to 256 columns take the register kernel, K = C2/32
    columns a thread (rounded up), whatever the shared-memory limit."""
    assert bsw_cuda.kernel_variant(L, C2, 0) == (K, 0)


@pytest.mark.parametrize("L,C2", [(8, 257), (8, 320), (16, 1024),
                                  (8, 3488)])
def test_kernel_variant_wide(L, C2):
    """Wider rows take the shared-memory kernel with its byte count."""
    limit = 232448                            # an H100 block's opt-in limit
    smem = bsw_cuda.wide_smem_bytes(L, C2)
    assert smem == 4 * (2 * L * C2 + L * ((C2 + 31) // 32 + 1) + 3 * L)
    assert smem <= limit
    assert bsw_cuda.kernel_variant(L, C2, limit) == (0, smem)


@pytest.mark.parametrize("L,C2,limit", [(8, 3600, 232448),
                                        (16, 2000, 232448), (8, 257, 1000),
                                        (0, 64, 232448), (33, 64, 232448)])
def test_kernel_variant_refuses(L, C2, limit):
    """Neither kernel fits: rows too wide for shared memory, or a group
    that is not 1..32 warps."""
    with pytest.raises(ValueError):
        bsw_cuda.kernel_variant(L, C2, limit)


def mask_rule(nz, beg, end):
    """The group band's first and last nonzero column as the previous
    shared-memory kernel took them: each pair ballots its nonzero F|H
    columns of [beg, end] in 32-column masks, the masks of the pairs are
    OR'd, and the first set bit (the bit of column `end` cleared) and
    the last set bit are read."""
    L, C2 = nz.shape
    nch = (end - beg) // 32 + 1 if end >= beg else 0
    first, last = 1 << 28, -1
    for k in range(nch):
        m = 0
        for lane in range(L):
            for j in range(32):
                c = beg + 32 * k + j
                if c <= end and c < C2 and nz[lane, c]:
                    m |= 1 << j
        if m:
            c0 = beg + 32 * k
            last = max(last, c0 + m.bit_length() - 1)
            if 0 <= end - c0 < 32:
                m &= ~(1 << (end - c0))
            if m:
                first = min(first, c0 + (m & -m).bit_length() - 1)
    return first, last


def min_max_rule(nz, beg, end):
    """The same columns as the register kernel takes them: the min over
    pairs of each pair's first nonzero column in [beg, end), the max of
    each pair's last in [beg, end]."""
    L, C2 = nz.shape
    cols = np.arange(C2)
    own_first = [int(np.where((cols >= beg) & (cols < end) & row, cols,
                              1 << 28).min()) for row in nz]
    own_last = [int(np.where((cols >= beg) & (cols <= end) & row, cols,
                             -1).max()) for row in nz]
    return min(own_first), max(own_last)


@pytest.mark.parametrize("seed", range(6))
def test_group_band_min_max_equals_mask_or(seed):
    """The register kernel's min/max of per-pair nonzero columns is the
    previous kernel's OR-of-masks rule, on random F|H rows and bands
    (empty, inverted, ending at or past the last column)."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        L = int(rng.choice([1, 8, 16]))
        C2 = int(rng.choice([32, 96, 160, 256]))
        nz = rng.random((L, C2)) < rng.choice([0.0, 0.02, 0.3, 0.9])
        beg = int(rng.integers(0, C2))
        end = int(rng.integers(max(beg - 5, 0), C2 + 1))
        assert min_max_rule(nz, beg, end) == mask_rule(nz, beg, end)
