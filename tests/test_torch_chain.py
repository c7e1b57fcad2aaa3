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
from genarchbench_tpu.kernels import fast_chain as jfc
from genarchbench_tpu_torch import cli, native
from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.kernels import chain, fast_chain
from genarchbench_tpu_torch.sharding.batching import plan_batches
from genarchbench_tpu_torch.sharding.mesh import data_mesh, shard_items
from tests.synth import gen_chain_input
from tests.torch_chain_inputs import (clz_text, deferral_text, dense_text,
                                      empty_single_text, ont_like_text,
                                      skip_break_text, sr_like_text, tie_text,
                                      wrap_text)

# tests/test_chain.py's sets: (seed, records, anchors, segments)
DATASETS = [(0, 10, 100, 1), (1, 25, 400, 1), (2, 8, 300, 2)]


INPUTS = {
    **{f"set{s}": (lambda s=s, nr=nr, ma=ma, ns=ns: gen_chain_input(
        np.random.default_rng(s), n_records=nr, max_anchors=ma, n_segs=ns))
       for s, nr, ma, ns in DATASETS},
    "skip-break": skip_break_text,
    "ties": tie_text,
    "empty-single": lambda: empty_single_text(gen_chain_input),
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


def shared_buffers(recs):
    """The records again, each x and y a view of one buffer of all their
    anchors, as the benchmark's adapter builds them."""
    x, y = (np.concatenate([getattr(r, a) for r in recs]) for a in "xy")
    offs = np.cumsum([0] + [r.n for r in recs]).tolist()
    return [dataclasses.replace(r, x=x[a:b], y=y[a:b])
            for r, a, b in zip(recs, offs[:-1], offs[1:])]


@pytest.mark.parametrize("entry", ["chain", "fast-chain"])
@pytest.mark.parametrize("name", ["set2", "deferral", "sr-like"])
def test_entries_on_shared_buffers(entry, name):
    """Both entries on records whose x and y are views of one buffer,
    against the JAX package on the reader's records and against the
    entry on the separately allocated records."""
    text = (sr_like_text(np.random.default_rng(32), 120)
            if name == "sr-like" else INPUTS[name]())
    ours, theirs = records(text)
    shared = shared_buffers(ours)
    assert all(r.x.base is shared[0].x.base for r in shared)
    fast = entry == "fast-chain"
    ours_fn = fast_chain.fast_chain_batch if fast else chain.chain_batch
    jax_fn = jfc.fast_chain_batch if fast else jchain.chain_batch
    got = ours_fn(shared, device="cpu")
    assert_same(got, jax_fn(theirs), peaks=not fast)
    assert_same(got, ours_fn(ours, device="cpu"), peaks=not fast)


PLAN_CASES = {
    "sr-like": lambda rng: sr_like_text(rng, 300),
    "ont-like": lambda rng: ont_like_text(rng, 5),
    "deferred-rows": lambda rng: sr_like_text(rng, 40),
    "one-record": lambda rng: ont_like_text(rng, 1),
    "shard-split": lambda rng: sr_like_text(rng, 77),
    "empty": lambda rng: "",
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_gathered_planes_equal_plain(case, monkeypatch):
    """The flat view's per-record parameters, anchors and window
    starts, each plan's planes gathered and decoded by flat offsets
    (`pad_planes`) and `plan_inputs`' parameters, bit for bit against
    the record-by-record plain versions (`ChainRecord.window_starts`,
    `pad_planes_plain`)."""
    recs, _ = records(PLAN_CASES[case](np.random.default_rng(31)))
    flat = chain_io.FlatRecords.of(recs, chain.MAX_ITER)
    for f, a, dt in (("n", "n", np.int64), ("max_dist_x",) * 2 + (np.int64,),
                     ("max_dist_y",) * 2 + (np.int64,),
                     ("bw", "bw", np.int64), ("n_segs",) * 2 + (np.int64,),
                     ("avg_qspan",) * 2 + (np.float32,)):
        want = np.array([getattr(r, a) for r in recs], dt)
        assert getattr(flat, f).dtype == dt
        np.testing.assert_array_equal(getattr(flat, f).view(want.dtype),
                                      want, err_msg=f)
    for f in "xy":
        np.testing.assert_array_equal(getattr(flat, f), np.concatenate(
            [getattr(r, f) for r in recs] + [np.zeros(0, np.uint64)]))
    ws = [r.window_starts(chain.MAX_ITER) for r in recs]
    np.testing.assert_array_equal(
        flat.st, np.concatenate(ws + [np.zeros(0, np.int32)]))
    for g, w in zip(chain_io.window_starts_all(recs, chain.MAX_ITER), ws):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    parts = [(np.asarray(p.indices), p.length) for p in plan_batches(
        flat.n, chain.CELL_BUDGET, chain.MAX_BATCH)]
    if case == "shard-split":
        monkeypatch.setenv("GENARCH_DEVICE", "cpu")
        parts = [(part, N) for idx, N in parts
                 for part in shard_items(idx, data_mesh(2))]
        assert parts[1][0][-1] == parts[1][0][-2]    # the padding repeat
    assert len(parts) == {"empty": 0, "shard-split": 2}.get(case, 1)
    for idx, N in parts:
        sub, sub_ws = [recs[k] for k in idx], [ws[k] for k in idx]
        n = flat.n[idx].astype(np.int32)
        if case == "deferred-rows":
            n[::3] = 0
        got = chain.pad_planes(flat, idx, n, N)
        assert got.dtype == np.int32 and got.shape == (5, len(idx), N)
        np.testing.assert_array_equal(
            got, chain.pad_planes_plain(sub, sub_ws, n, N))
        plan = chain.plan_inputs(flat, idx, N)
        for f, a in (("mdx", "max_dist_x"), ("mdy", "max_dist_y"),
                     ("bw", "bw"), ("nsegs", "n_segs")):
            np.testing.assert_array_equal(
                getattr(plan, f), np.array([getattr(r, a) for r in sub],
                                           np.int32), err_msg=f)
        np.testing.assert_array_equal(
            plan.avg32.view(np.int32),
            np.array([r.avg_qspan for r in sub], np.float32).view(np.int32))
        np.testing.assert_array_equal(
            plan.n, [0 if o else r.n for r, o in zip(sub, plan.over)])
        np.testing.assert_array_equal(
            plan.planes, chain.pad_planes_plain(sub, sub_ws, plan.n, N))
    if case == "ont-like":              # avg_qspan 15 rows defer, others not
        assert 0 < plan.over.sum() < len(recs)
    assert chain.pad_planes(flat, np.zeros(0, np.int64), np.zeros(0, np.int32),
                            16).shape == (5, 0, 16)


def test_flat_records_refuse_a_wrong_count():
    """A record whose n is not its number of anchors is refused."""
    recs, _ = records(sr_like_text(np.random.default_rng(33), 5))
    recs[2] = dataclasses.replace(recs[2], n=recs[2].n + 1)
    with pytest.raises(ValueError, match="n uint64 each"):
        chain_io.FlatRecords.of(recs, chain.MAX_ITER)


def test_skip_break_input_reaches_the_break():
    """The stress input's parents differ from the JAX function's without
    the skip heuristic, in the kernel and in the C scalar DP alike."""
    ours, theirs = records(skip_break_text())
    without = jchain.chain_batch(theirs, with_heuristics=False)
    flat = chain_io.FlatRecords.of(ours, chain.MAX_ITER)
    for got in (chain.chain_batch(ours, device="cpu"),
                chain.scalar_dp(flat, np.arange(len(ours)))):
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


def run_plan(plan):
    """The windowed kernel on one plan on the CPU, as `chain.run_plans`
    runs it: (3, B, N) scores, parents and peaks."""
    dev = torch.device("cpu")
    return torch.stack(chain.window_dp(plan, chain.upload_plan(plan, dev))) \
        .numpy()


@pytest.mark.parametrize("name", ["set0", "set1", "set2", "skip-break",
                                  "ties", "dense", "u32-wrap",
                                  "shard-padding"])
def test_kernels_agree_on_a_plan(name):
    """The kernel at the plan's window width, at the full padded width
    and the C scalar DP on the same plan, and the C scalar DP on the
    plan's records read at their offsets in the whole batch's flat view
    against the same records laid out alone.  "shard-padding" takes
    set1's records out of order, the last repeated as a mesh's shard
    padding repeats it (`sharding/mesh.py::shard_index`)."""
    recs, _ = records(INPUTS["set1" if name == "shard-padding"
                             else name]())
    idx = (np.array([3, 0, 17, 9, 24, 24, 24]) if name == "shard-padding"
           else np.arange(len(recs)))
    flat = chain_io.FlatRecords.of(recs, chain.MAX_ITER)
    N = 1 << int(np.ceil(np.log2(max(recs[k].n for k in idx))))
    plan = chain.plan_inputs(flat, idx, N)
    assert not plan.over.any()
    assert (plan.W == N) == (name == "dense")
    win = run_plan(plan)
    full = run_plan(dataclasses.replace(plan, W=N))
    np.testing.assert_array_equal(win, full)
    alone = chain.scalar_dp(chain_io.FlatRecords.of(
        [recs[k] for k in idx], chain.MAX_ITER), np.arange(len(idx)))
    for b, res in enumerate(chain.scalar_dp(flat, idx)):
        np.testing.assert_array_equal(win[:, b, :recs[idx[b]].n],
                                      np.stack(res))
        np.testing.assert_array_equal(np.stack(res), np.stack(alone[b]))


def test_clz_boundaries(monkeypatch):
    """log2 of dd = 2^k - 1 and 2^k through the kernel, against the C
    scalar DP (31 - __builtin_clz) and the JAX windowed kernel.  The
    2^31-wide gap-correction scan is replaced by its known answer: avg 0
    makes both products 0."""
    recs, _ = records(clz_text())
    monkeypatch.setattr(chain, "gap_corrections", lambda avg32, t, ck=4: (
        np.full((len(avg32), ck), -1, np.int32),
        np.zeros((len(avg32), ck), np.int32), np.zeros(len(avg32), bool)))
    flat = chain_io.FlatRecords.of(recs, chain.MAX_ITER)
    plan = chain.plan_inputs(flat, np.arange(len(recs)), 64)
    assert plan.W == 64
    win = run_plan(plan)
    for b, res in enumerate(chain.scalar_dp(flat, np.arange(len(recs)))):
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
    x = np.array([1, 2], np.uint64)
    y = np.array([15 << 32 | 1, 15 << 32 | 2], np.uint64)
    params = ([20.0], [5000], [5000], [500], [1])
    with pytest.raises(ValueError, match="window starts"):
        native.chain_dp_scalar(x, y, [0, 2], [0], [2], *params)
    with pytest.raises(ValueError, match="lie in the flat arrays"):
        native.chain_dp_scalar(x, y, [0, 0], [1], [2], *params)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.build()
