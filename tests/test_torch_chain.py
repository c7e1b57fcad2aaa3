"""The port's chain path against the JAX package, on the CPU.

Every comparison is exact: `chain_batch`'s scores, parents and peaks
against the JAX function's, each CLI's output file against the JAX
CLI's byte for byte, the kernel at the plan's window width, at the
full padded width and the C scalar DP against each other on one plan,
and the C gap corrections against their dense scan.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from genarchbench_tpu import native as jax_native
from genarchbench_tpu.io import chain_io as jax_chain_io
from genarchbench_tpu.kernels import chain as jchain
from genarchbench_tpu_torch import cli, native
from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.kernels import chain
from tests.synth import gen_chain_input
from tests.torch_chain_inputs import (chain_text, clz_text, deferral_text,
                                      dense_text, skip_break_text, tie_text,
                                      wrap_text)

# tests/test_chain.py's sets: (seed, records, anchors, segments)
DATASETS = [(0, 10, 100, 1), (1, 25, 400, 1), (2, 8, 300, 2)]


def empty_single_text():
    text = gen_chain_input(np.random.default_rng(7), n_records=3,
                           max_anchors=2)
    return text + chain_text([(20.5, 5000, 5000, 500, 1, [], []),
                              (12.0, 5000, 5000, 500, 1, [40],
                               [(15 << 32) | 9])])


INPUTS = {
    **{f"set{s}": (lambda s=s, nr=nr, ma=ma, ns=ns: gen_chain_input(
        np.random.default_rng(s), n_records=nr, max_anchors=ma, n_segs=ns))
       for s, nr, ma, ns in DATASETS},
    "skip-break": skip_break_text,
    "ties": tie_text,
    "empty-single": empty_single_text,
    "deferral": deferral_text,
    "dense": dense_text,
    "u32-wrap": wrap_text,
}


def records(text):
    return (list(chain_io.read_records(io.StringIO(text))),
            list(jax_chain_io.read_records(io.StringIO(text))))


def assert_same(got, want, peaks=True):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("scores", "parents", "peaks")[:2 + peaks],
                              g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"record {k} {name}")


@pytest.mark.parametrize("name", list(INPUTS))
def test_chain_batch_equal(name):
    ours, theirs = records(INPUTS[name]())
    stats = {}
    got = chain.chain_batch(ours, device="cpu", stats=stats)
    assert_same(got, jchain.chain_batch(theirs))
    assert all(g[0].dtype == g[1].dtype == g[2].dtype == np.int32
               for g in got)
    # the window spans the padded row where every anchor lies in one
    # window, and where one-anchor records pad to 16, under 32
    full = name in ("dense", "empty-single")
    assert len(stats["widths"]) == stats["plans"] >= 1
    assert all((W == N) == full for W, N in stats["widths"])
    assert stats["deferred"] == (3 if name == "deferral" else 0)
    if name == "ties":                  # the later of the tied pair wins
        assert got[0][1][128] == 127 and got[0][1][256] == 255


def test_skip_break_input_reaches_the_break():
    """The stress input's parents differ from the JAX function's without
    the skip heuristic, in the kernel and in the C scalar DP alike."""
    ours, theirs = records(skip_break_text())
    without = jchain.chain_batch(theirs, with_heuristics=False)
    ws = chain_io.window_starts_all(ours, chain.MAX_ITER)
    for got in (chain.chain_batch(ours, device="cpu"),
                chain.scalar_dp(ours, ws)):
        assert any(not np.array_equal(a[1], b[1])
                   for a, b in zip(got, without))


@pytest.mark.parametrize("name", list(INPUTS))
def test_cli_matches_jax_run(tmp_path, monkeypatch, capsys, name):
    inp = tmp_path / "in.txt"
    inp.write_text(INPUTS[name]())
    jchain.run(["-i", str(inp), "-o", str(tmp_path / "jax.txt")])
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    assert cli.main(["run", "chain", "-i", str(inp), "-o",
                     str(tmp_path / "port.txt")]) == 0
    assert "Time in kernel: " in capsys.readouterr().err
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("name", ["set0", "set1", "set2", "skip-break",
                                  "ties", "dense", "u32-wrap"])
def test_kernels_agree_on_a_plan(name):
    """The kernel at the plan's window width, at the full padded width
    and the C scalar DP on the same plan."""
    recs, _ = records(INPUTS[name]())
    ws = chain_io.window_starts_all(recs, chain.MAX_ITER)
    N = 1 << int(np.ceil(np.log2(max(r.n for r in recs))))
    plan = chain.plan_inputs(recs, ws, N)
    assert not plan.over.any()
    assert (plan.W == N) == (name == "dense")
    win = chain.run_plan(plan, torch.device("cpu"))
    full = chain.run_plan(dataclasses.replace(plan, W=N), torch.device("cpu"))
    np.testing.assert_array_equal(win, full)
    for b, res in enumerate(chain.scalar_dp(recs, ws)):
        np.testing.assert_array_equal(win[:, b, :recs[b].n], np.stack(res))


def test_clz_boundaries(monkeypatch):
    """log2 of dd = 2^k - 1 and 2^k through the kernel, against the C
    scalar DP (31 - __builtin_clz) and the JAX windowed kernel.  The
    2^31-wide gap-correction scan is replaced by its known answer: avg 0
    makes both products 0."""
    recs, _ = records(clz_text())
    monkeypatch.setattr(chain, "gap_corrections", lambda avg32, t, ck=4: (
        np.full((len(avg32), ck), -1, np.int32),
        np.zeros((len(avg32), ck), np.int32), np.zeros(len(avg32), bool)))
    ws = chain_io.window_starts_all(recs, chain.MAX_ITER)
    plan = chain.plan_inputs(recs, ws, 64)
    assert plan.W == 64
    win = chain.run_plan(plan, torch.device("cpu"))
    for b, res in enumerate(chain.scalar_dp(recs, ws)):
        np.testing.assert_array_equal(win[:, b, :recs[b].n], np.stack(res))
    # the JAX windowed kernel on the same arrays
    x_lo, qi, span, sid, st = plan.planes
    width = np.arange(64, dtype=np.int32) - st
    B = len(recs)
    out = jchain._chain_dp_win_device(
        x_lo.view(np.uint32), qi, span, sid, width, plan.n, plan.mdx,
        plan.mdy, plan.bw, plan.nsegs, np.zeros((B, 1), np.int32),
        plan.avg32, plan.corr_dd, plan.corr_delta, W=64)
    np.testing.assert_array_equal(win, np.stack([np.asarray(a) for a in out]))
    # a wrong log2 at a boundary would change some chain's score
    assert win[1].max() > 0


def test_log2_floor():
    ks = np.arange(31)
    dd = np.unique(np.concatenate([[0, 2**31 - 1], 1 << ks,
                                   (1 << ks) - 1, (1 << ks) + 1]))
    dd = dd[dd < 2**31]
    want = np.array([int(v).bit_length() - 1 if v > 0 else 0 for v in dd])
    got = chain._log2_floor(torch.from_numpy(dd.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gap_corrections_c_vs_dense_scan():
    """The C candidate scan against the dense scan (and the JAX package's
    C copy) over a wide avg range: the tiny-avg dense branch, rows over
    CORR_K and rows past SAFE_PROD."""
    rng = np.random.default_rng(0)
    avgs = np.concatenate(
        [rng.uniform(2.0, 400.0, 120), rng.uniform(0.2, 2.0, 20),
         [10.0, 25.5, 39.99, 655.0, 104.487175, 27.5]]).astype(np.float32)
    got = chain.gap_corrections(avgs, 5001)
    want = chain.gap_corrections_plain(avgs, 5001)
    jax_res = jax_native.chain_gap_corr_native(avgs, 5001, chain.CORR_K,
                                               chain.SAFE_PROD)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if jax_res is not None:
        for a, b in zip(got, jax_res):
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    assert got[2].any() and not got[2].all()


def test_linear_gap_equals_f64_table():
    """The kernel's f32 product plus the corrections equals the C's f64
    gap cost for every dd of every row that is not deferred, including
    boundary products such as dd = 40 at avg 27.5."""
    avgs = np.concatenate([np.random.default_rng(1).uniform(2, 300, 60),
                           [27.5, 10.0, 1.3]]).astype(np.float32)
    t_size = 5001
    cdd, cdel, over = chain.gap_corrections(avgs, t_size)
    plan = chain.ChainPlan(None, None, *(np.zeros(len(avgs), np.int32),) * 4,
                           avgs, cdd, cdel, over, 0)
    p = chain._Params(plan, torch.device("cpu"))
    dd = torch.arange(t_size, dtype=torch.int32).expand(len(avgs), t_size)
    got = chain._linear_gap(dd.contiguous(), p).numpy()
    for r in np.flatnonzero(~over):
        np.testing.assert_array_equal(got[r], chain.clin_table(avgs[r],
                                                               t_size))
    # the same float32 product without corrections is off somewhere
    assert (cdd >= 0).any()


def test_scalar_dp_checks_inputs():
    with pytest.raises(ValueError, match="window starts"):
        native.chain_dp_scalar([2], [20.0], [5000], [5000], [500], [1],
                               [1, 2], [1, 2], [15, 15], [0, 0], [0, 2])
    with pytest.raises(ValueError, match="x_lo must be"):
        native.chain_dp_scalar([2], [20.0], [5000], [5000], [500], [1],
                               [1], [1, 2], [15, 15], [0, 0], [0, 0])


def test_failed_native_build_raises(tmp_path, monkeypatch):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build()
