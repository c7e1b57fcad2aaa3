"""The contract of fast-chain's anchor-loop kernel (csrc/fast_chain.cu),
on the CPU and on the card.

On the CPU, a scalar model of the kernel's order (one record at a time,
its anchors in order, the predecessors of anchor i taken by 32 lanes in
strides of 32 from i - 1 down, each lane keeping its best, then the
warp's butterfly to the maximum, ties to the largest j) is held to the
tiled torch-op loop (`kernels/fast_chain.py::_fast_chain_device`) on
every cell of each plan, and to a scalar model of the reference loop
(`reference`, fast-chain/src/host_kernel.cpp:803-866) on every record.
The wrapper's checks and the CPU path's independence of it are tested
too.  On the card (tests marked `card`, which skip without one), the
kernel is held to the torch-op loop run on the card, with its stores in
shared memory and in device memory, and `fast_chain_batch` to its CPU
run, one launch a plan.  This file imports no JAX: on the card run it
with `python -m pytest tests/test_torch_fast_chain_kernel.py --noconftest
-m card`.
"""

import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.kernels import fast_chain, fast_chain_cuda
from genarchbench_tpu_torch.kernels.chain import MAX_ITER
from genarchbench_tpu_torch.sharding.batching import plan_batches


def _input_module(name):
    """tests/<name>.py by path: without this directory's conftest, `tests`
    may name another installation's package."""
    spec = importlib.util.spec_from_file_location(
        f"fast_chain_kernel_{name}", pathlib.Path(__file__).with_name(
            f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


synth = _input_module("synth")
ci = _input_module("torch_chain_inputs")


def long_text(seed=31, sizes=(300, 190)):
    """Records of hundreds of anchors 1-30 apart under max_dist_x 5000:
    windows of well over 32 predecessors, many far chunks deep."""
    rng = np.random.default_rng(seed)
    recs = []
    for n in sizes:
        x = 7 + np.cumsum(rng.integers(1, 30, n)).astype(np.uint64)
        q = np.cumsum(rng.integers(1, 30, n)).astype(np.uint64)
        recs.append((float(np.float32(rng.uniform(10, 40))), 5000, 5000, 500,
                     1, x, ci.SPAN15 | q))
    return ci.chain_text(recs)


# tests/test_torch_fast_chain.py's FAST_INPUTS, and long records
SETS = {
    **{f"set{s}": (lambda s=s, nr=nr, ma=ma: synth.gen_chain_input(
        np.random.default_rng(s), n_records=nr, max_anchors=ma))
       for s, nr, ma in [(3, 10, 100), (4, 20, 400)]},
    "skip-break": ci.skip_break_text,
    "ties": ci.tie_text,
    "empty-single": lambda: ci.empty_single_text(synth.gen_chain_input),
    "deferral": ci.deferral_text,
    "dense": ci.dense_text,
    "u32-wrap": ci.wrap_text,
    "long": long_text,
}


def records(text):
    return list(chain_io.read_records(io.StringIO(text)))


def plans(recs):
    """[(records' indices, host inputs)] of `fast_chain_batch`'s plans."""
    flat = chain_io.FlatRecords.of(recs, MAX_ITER)
    out = []
    for plan in plan_batches(flat.n, fast_chain.CELL_BUDGET,
                             fast_chain.MAX_BATCH):
        idx = np.asarray(plan.indices)
        out.append((idx, fast_chain.plan_inputs(flat, idx, plan.length)[0]))
    return out


def i32(v):
    return (v + 2**31) % 2**32 - 2**31


# ---------------------------------------------------------------------------
# the scalar models
# ---------------------------------------------------------------------------

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


def f32_to_i32(v: np.float32) -> int:
    """__float2int_rz: truncation, saturated to int32."""
    return 0 if np.isnan(v) else int(min(max(np.trunc(v), -2**31),
                                         2**31 - 1))


def pair_score(xi, qi, spi, xj, qj, scj, mdxy, bw, avg):
    """The kernel's score of predecessor j for anchor i in int32 that
    wraps, or None where the reference continues."""
    dr, dq = i32(xi - xj), i32(qi - qj)
    d = i32(dr - dq)
    dd = i32(-d) if d < 0 else d
    if dr == 0 or dq <= 0 or dq > mdxy or dd > bw:
        return None
    c_lin = f32_to_i32((np.float32(dd) * np.float32(0.01)) * avg)
    log_dd = dd.bit_length() - 1 if dd > 0 else 0
    return i32(i32(min(dq, dr, spi) - i32(c_lin + (log_dd >> 1))) + scj)


def model_plan(host):
    """One plan as the kernel runs it: (scores, parents) (B, N) int32."""
    (planes, mdxy, bw, avg), steps, _ = host
    x, q, sp, _, st = (p.tolist() for p in planes)
    B, N = planes.shape[1:]
    scores = np.zeros((B, N), np.int32)
    parents = np.full((B, N), -1, np.int32)
    for b in range(B):
        ss = [0] * N                 # the record's scores so far
        for i in range(steps):
            lanes = []
            for lane in range(32):
                best = (sp[b][i], -1)
                for j in range(i - 1 - lane, st[b][i] - 1, -32):
                    sc = pair_score(x[b][i], q[b][i], sp[b][i], x[b][j],
                                    q[b][j], ss[j], int(mdxy[b]), int(bw[b]),
                                    avg[b])
                    if sc is not None and sc > best[0]:
                        best = (sc, j)
                lanes.append(best)
            if st[b][i] < i:
                for off in (16, 8, 4, 2, 1):
                    # a total order: the larger score, then the larger j
                    lanes = [max(lanes[k], lanes[k ^ off]) for k in range(32)]
            ss[i], parents[b, i] = lanes[0]
        scores[b] = ss
    return scores, parents


def torch_loop(host, dev):
    """`_fast_chain_device` on one plan's inputs uploaded to dev."""
    _, steps, chunks = host
    (x_lo, qi, q_span, _, st), mdxy, bw, avg = fast_chain._upload(host, dev)
    return fast_chain._fast_chain_device(x_lo, qi, q_span, st, mdxy, bw, avg,
                                         steps, chunks)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SETS))
def test_model_equals_torch_loop_and_reference(name):
    recs = records(SETS[name]())
    for idx, host in plans(recs):
        got = model_plan(host)
        want = torch_loop(host, "cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        for row, k in enumerate(idx.tolist()):
            ws, wp = reference(recs[k])
            np.testing.assert_array_equal(got[0][row, :recs[k].n], ws)
            np.testing.assert_array_equal(got[1][row, :recs[k].n], wp)
    if name == "ties":       # the later of the tied pair wins, far or near
        (idx, host), = plans(recs)
        pa = model_plan(host)[1][list(idx).index(0)]
        assert pa[128] == 127 and pa[256] == 255
    if name == "long":       # windows deeper than a warp and a far chunk
        (_, ((planes, *_), steps, chunks)), = plans(recs)
        assert steps > 128 and sum(chunks) > 0
        assert (np.arange(planes.shape[2]) - planes[4]).max() > 128


def test_pair_score_at_the_gap_cost_boundaries():
    """dd = 40 at avg_qspan 27.5 truncates 10.999999f to 10 (the
    reference's min(100, 140, 15) - (10 + 2) + 15 = 18); the int32
    difference of x's low words wraps like the C's uint32."""
    assert pair_score(1140, 1100, 15, 1000, 1000, 15, 5000, 500,
                      np.float32(27.5)) == 18
    # low words 50 and 2^32 - 20: dr 70, dd 30; 30 * 0.01f = 0.29999998f,
    # times 20 is 5.9999995f, which truncates to 5: 15 - (5 + 2)
    assert pair_score(50, 200, 15, i32(2**32 - 20), 100, 0, 5000, 500,
                      np.float32(20.0)) == 8
    assert pair_score(1000, 1000, 15, 900, 1000, 0, 5000, 500,
                      np.float32(20.0)) is None        # dq = 0


@pytest.mark.parametrize("N,shared", [(64, True), (1024, True),
                                      (2048, False), (8192, False)])
def test_store_placement_follows_the_plan_length(N, shared):
    """A block's four records keep x, q and their scores in shared memory
    where they fit in 48 KB, else in device memory."""
    assert fast_chain_cuda.store_bytes(N) == 4 * 3 * 4 * N
    assert fast_chain_cuda.in_shared(N) == shared


def test_cpu_tensors_run_the_torch_loop(monkeypatch):
    """CPU tensors never reach the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the kernel was called for CPU tensors")
    monkeypatch.setattr(fast_chain_cuda, "fast_chain", refuse)
    recs = records(SETS["set3"]())
    got = fast_chain.fast_chain_batch(recs, device="cpu")
    for r, (s, p, _) in zip(recs, got):
        np.testing.assert_array_equal(s, reference(r)[0])
        np.testing.assert_array_equal(p, reference(r)[1])


def cpu_inputs():
    (_, host), = plans(records(SETS["set3"]()))
    (x_lo, qi, q_span, _, st), mdxy, bw, avg = fast_chain._upload(host,
                                                                  "cpu")
    return [x_lo, qi, q_span, st, mdxy, bw, avg, host[1]]


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="runs on cuda"):
        fast_chain_cuda.fast_chain(*cpu_inputs())


@pytest.mark.parametrize("bad,match", [
    (lambda t: (t[0][0], *t[1:]), r"x_lo must be \(B, N\)"),
    (lambda t: (t[0].long(), *t[1:]), "x_lo must be torch.int32"),
    (lambda t: (*t[:4], t[4][:-1], *t[5:]), "mdxy must be torch.int32"),
    (lambda t: (*t[:6], t[6].double(), t[7]), "avg must be torch.float32"),
    (lambda t: (t[0], t[1].t().contiguous().t(), *t[2:]),
     "qi must be contiguous"),
    (lambda t: (*t[:3], t[3].to("meta"), *t[4:]), "st is on meta"),
    (lambda t: (*t[:7], t[0].shape[1] + 1), "steps"),
])
def test_wrapper_checks_its_inputs(bad, match):
    """Shapes, types, devices, layout and the step count are checked
    before any pointer reaches the kernel."""
    with pytest.raises(ValueError, match=match):
        fast_chain_cuda._check(*bad(cpu_inputs()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The card's device name; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return torch.cuda.get_device_name(0)


def kernel_vs_torch_loop(recs):
    """The kernel and the torch-op loop on the card, plan by plan: equal
    on every cell.  Returns the plans' padded lengths."""
    lengths = []
    for _, host in plans(recs):
        (x_lo, qi, q_span, _, st), mdxy, bw, avg = fast_chain._upload(
            host, "cuda")
        launches = fast_chain_cuda.LAUNCHES
        got = fast_chain_cuda.fast_chain(x_lo, qi, q_span, st, mdxy, bw, avg,
                                         host[1])
        assert fast_chain_cuda.LAUNCHES == launches + 1
        want = torch_loop(host, "cuda")
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        lengths.append(x_lo.shape[1])
    return lengths


@pytest.mark.card
@pytest.mark.parametrize("name", list(SETS))
def test_kernel_equals_torch_loop_on_card(card, name):
    kernel_vs_torch_loop(records(SETS[name]()))


@pytest.mark.card
def test_kernel_with_its_stores_in_device_memory_on_card(card):
    """Records of 1,500-3,000 anchors pad to N of 2048 or 4096, past what
    shared memory holds: the same kernel reads its predecessors and
    scores from device memory."""
    lengths = kernel_vs_torch_loop(records(ci.ont_like_text(
        np.random.default_rng(32), 4) + long_text(33, (1500, 2100))))
    assert not all(fast_chain_cuda.in_shared(N) for N in lengths)


@pytest.mark.card
def test_batch_on_card_equals_cpu_run(card):
    """`fast_chain_batch` on the card: one kernel launch a plan, scores and
    parents those of the CPU run."""
    recs = records(ci.sr_like_text(np.random.default_rng(34), 9000)
                   + ci.tie_text() + ci.wrap_text())
    stats = {}
    launches = fast_chain_cuda.LAUNCHES
    got = fast_chain.fast_chain_batch(recs, device="cuda", stats=stats)
    assert stats["plans"] >= 3
    assert fast_chain_cuda.LAUNCHES == launches + stats["plans"]
    want = fast_chain.fast_chain_batch(recs, device="cpu")
    for (gs, gp, _), (ws, wp, _) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)


@pytest.mark.card
def test_two_shards_of_one_card(card):
    """`fast_chain_batch(mesh=)` with two shards on the one card: one
    launch a shard's plan, the CPU run's results."""
    from genarchbench_tpu_torch.sharding.mesh import Mesh
    recs = records(ci.sr_like_text(np.random.default_rng(35), 300)
                   + long_text())
    dev = torch.device("cuda", 0)
    stats = {}
    launches = fast_chain_cuda.LAUNCHES
    got = fast_chain.fast_chain_batch(recs, stats=stats, mesh=Mesh((dev, dev)))
    assert fast_chain_cuda.LAUNCHES == launches + stats["plans"]
    want = fast_chain.fast_chain_batch(recs, device="cpu")
    for (gs, gp, _), (ws, wp, _) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gp, wp)
