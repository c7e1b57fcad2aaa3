"""The port's fast-chain path against the JAX package, on the CPU.

Exact comparisons: `fast_chain_batch`'s scores and parents against the
JAX function's, the CLI's output file against the JAX CLI's byte for
byte, and a scalar Python model of the reference loop
(fast-chain/src/host_kernel.cpp:803-866) on small inputs.
"""

import numpy as np
import pytest

from genarchbench_tpu.kernels import fast_chain as jfc
from genarchbench_tpu_torch import cli
from genarchbench_tpu_torch.kernels import fast_chain
from genarchbench_tpu_torch.kernels.chain import MAX_ITER
from tests.synth import gen_chain_input
from tests.test_torch_chain import INPUTS, assert_same, records
from tests.torch_chain_inputs import boundary_text, clz_text

# tests/test_fast_chain.py's sets: (seed, records, anchors)
FAST_INPUTS = {
    **{f"set{s}": (lambda s=s, nr=nr, ma=ma: gen_chain_input(
        np.random.default_rng(s), n_records=nr, max_anchors=ma))
       for s, nr, ma in [(3, 10, 100), (4, 20, 400)]},
    **{k: INPUTS[k] for k in ("skip-break", "ties", "empty-single",
                              "deferral", "dense", "u32-wrap")},
}


def reference(rec):
    """The reference's scalar loop, its f32 gap cost from
    `clin_table_f32`: (scores, parents)."""
    n = rec.n
    x, q, sp, st = (a.tolist() for a in (rec.x_lo, rec.qi, rec.q_span,
                                         rec.window_starts(MAX_ITER)))
    mdxy = min(rec.max_dist_x, rec.max_dist_y)
    clin = fast_chain.clin_table_f32(rec.avg_qspan, rec.bw + 1)
    scores = np.zeros(n, np.int64)
    parents = np.full(n, -1, np.int64)

    def i32(v):
        return (v + 2**31) % 2**32 - 2**31

    for i in range(n):
        max_f, max_j = sp[i], -1
        for j in range(i - 1, st[i] - 1, -1):
            dr = i32(x[i] - x[j])
            dq = i32(q[i] - q[j])
            if dr == 0 or dq <= 0 or dq > mdxy:
                continue
            dd = abs(dr - dq)
            if dd > rec.bw:
                continue
            log_dd = dd.bit_length() - 1 if dd else 0
            sc = min(dq, dr, sp[i]) - (int(clin[dd]) + (log_dd >> 1)) \
                + scores[j]
            if sc > max_f:
                max_f, max_j = sc, j
        scores[i], parents[i] = max_f, max_j
    return scores, parents


@pytest.mark.parametrize("name", list(FAST_INPUTS))
def test_fast_chain_batch_equal(name):
    ours, theirs = records(FAST_INPUTS[name]())
    stats = {}
    got = fast_chain.fast_chain_batch(ours, device="cpu", stats=stats)
    assert_same(got, jfc.fast_chain_batch(theirs), peaks=False)
    assert all(g[0].dtype == g[1].dtype == np.int32 and g[2] is None
               for g in got)
    assert stats["near_steps"] == sum(
        max(ours[k].n for k in p.indices) for p in fast_chain.plan_batches(
            [r.n for r in ours], fast_chain.CELL_BUDGET, fast_chain.MAX_BATCH))
    if name == "ties":       # the later of the tied pair wins, far or near
        assert got[0][1][128] == 127 and got[0][1][256] == 255


@pytest.mark.parametrize("name", list(FAST_INPUTS))
def test_cli_matches_jax_run(tmp_path, monkeypatch, capsys, name):
    inp = tmp_path / "in.txt"
    inp.write_text(FAST_INPUTS[name]())
    jfc.run(["-i", str(inp), "-o", str(tmp_path / "jax.txt")])
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    assert cli.main(["run", "fast-chain", "-i", str(inp), "-o",
                     str(tmp_path / "port.txt")]) == 0
    assert "Time in kernel: " in capsys.readouterr().err
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("text", [boundary_text, INPUTS["ties"],
                                  INPUTS["u32-wrap"], INPUTS["dense"],
                                  FAST_INPUTS["set3"]],
                         ids=["dd40-avg27.5", "ties", "u32-wrap", "dense",
                              "set3"])
def test_reference_loop(text):
    recs, _ = records(text())
    got = fast_chain.fast_chain_batch(recs, device="cpu")
    for r, (s, p, _) in zip(recs, got):
        ws, wp = reference(r)
        np.testing.assert_array_equal(s, ws)
        np.testing.assert_array_equal(p, wp)
    if text is boundary_text:   # min(100, 140, 15) - (10 + 2) + 15
        assert got[0][0][1] == 18


def test_clz_boundaries():
    """log2 of dd = 2^k - 1 and 2^k, k = 1..30, windows many chunks deep
    (max_dist_x = 2^31 - 1), against the JAX function."""
    recs, theirs = records(clz_text())
    stats = {}
    got = fast_chain.fast_chain_batch(recs, device="cpu", stats=stats)
    assert_same(got, jfc.fast_chain_batch(theirs), peaks=False)
    assert max(g[0].max() for g in got) > 0


def test_far_chunks():
    st = np.tile(np.arange(512, dtype=np.int32), (3, 1))
    st[1, 300:] = 5                    # one lane reaches back to anchor 5
    assert fast_chain.far_chunks(st, 512) == [0, 0, 2, 3]
    assert fast_chain.far_chunks(st, 200) == [0, 0]
    st[1, 300:] = 299
    assert fast_chain.far_chunks(st, 512) == [0, 0, 0, 1]
