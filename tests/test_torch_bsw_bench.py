"""The port's bsw entry as the benchmark reads it, on the CPU: each call
of `bsw_batch` is one `bsw.batch` root tiled by its phase spans, with
the counts `bsw.pairs` and `bsw.groups`; and its scores equal the
benchmark's plain reference (`h100_bench/reference/bsw.py`, loaded by
path as the benchmark loads it) exactly, on seed extensions from the
benchmark's generator, as the JAX package's `bsw_batch` does."""

import json

import numpy as np
import pytest

from genarchbench_tpu.io.bsw_io import BswPairs as JaxPairs
from genarchbench_tpu.kernels import bsw as jbsw
from genarchbench_tpu_torch.core import roi
from genarchbench_tpu_torch.io.bsw_io import AMBIG_SENTINEL, BswPairs
from genarchbench_tpu_torch.kernels import bsw
from genarchbench_tpu_torch.sharding.mesh import data_mesh
from h100_bench.generators import extensions
from h100_bench.harness.cell import BENCH_DIR, load_module

TRAFFIC = json.loads((BENCH_DIR / "traffic" / "bwamem2.json").read_text())
CONFIG = json.loads((BENCH_DIR / "configs" / "bsw.json").read_text())
KEYS = ("match", "mismatch", "ambig", "o_del", "e_del", "o_ins", "e_ins",
        "zdrop", "w", "end_bonus")
# bwa mem's defaults, and another scoring with a narrower band
SCORINGS = [{k: CONFIG[k] for k in KEYS},
            dict(match=2, mismatch=3, ambig=-2, o_del=5, e_del=2, o_ins=4,
                 e_ins=1, zdrop=40, w=30, end_bonus=3)]
reference = load_module(BENCH_DIR / "reference" / "bsw.py")


def extension_batch(seed, pairs, slice_pairs):
    t = dict(TRAFFIC, contigs=[300000, 200000], pairs=pairs,
             slice_pairs=slice_pairs)
    return extensions.batches(t, seed, [0])[0]


def port_pairs(batch, ambiguous=False):
    """The batch as the port's BswPairs; with `ambiguous`, pair 3's
    query and pair 5's target hold an N (0xFFFF) at their third base."""
    refs = [r.astype(np.int32) for r in batch.targets()]
    quers = [q.astype(np.int32) for q in batch.queries()]
    if ambiguous:
        for seqs, p in ((quers, 3), (refs, 5)):
            assert len(seqs[p]) >= 3
            seqs[p][2] = AMBIG_SENTINEL
    return BswPairs(batch.h0.astype(np.int32), refs, quers)


def as_reference_batch(batch, pairs):
    """`batch` with the bases of `pairs` (N as 4)."""
    def flat(seqs):
        return np.concatenate([np.where(s == AMBIG_SENTINEL, 4, s)
                               for s in seqs]).astype(np.uint8)
    return extensions.ExtensionBatch(batch.n, batch.h0, batch.r_offs,
                                     batch.q_offs, flat(pairs.refs),
                                     flat(pairs.quers))


def traced(pairs, **kwargs):
    """(the scores, the spans and counts the call appended)."""
    _, before = roi.records()
    out = bsw.bsw_batch(pairs, **kwargs)
    recs, after = roi.records()
    recs = recs[len(recs) - (after - before):]
    return (out, [r for r in recs if isinstance(r, roi.Span)],
            [r for r in recs if isinstance(r, roi.Count)])


@pytest.fixture
def cpu_mesh(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    return data_mesh(2)


# (pairs, batch_size, shards): one sort slice; three slices; three slices
# on a two-shard CPU mesh
CASES = [(40, 512, 1), (150, 64, 1), (150, 64, 2)]


@pytest.mark.parametrize("n,batch_size,shards", CASES)
def test_a_call_is_one_root_tiled_by_its_phases(cpu_mesh, n, batch_size,
                                                shards):
    pairs = port_pairs(extension_batch(31 + n, n, batch_size))
    mesh = cpu_mesh if shards == 2 else None
    out, spans, counts = traced(pairs, batch_size=batch_size, device="cpu",
                                mesh=mesh)
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == ["bsw.batch"]
    root = roots[0]
    assert all(s.root == root.id for s in spans)
    children = sorted((s for s in spans if s.parent == root.id),
                      key=lambda s: s.t0)
    assert len(children) == len(spans) - 1       # no span below a phase
    for a, b in zip(children, children[1:]):
        assert root.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= root.t1
    assert [s.name for s in children] == (
        ["bsw.prep"] + ["bsw.h2d", "bsw.kernel"] * shards
        + ["bsw.d2h"] * shards)
    covered = sum(s.t1 - s.t0 for s in children)
    assert covered >= 0.98 * (root.t1 - root.t0)
    groups = bsw.group_pairs(n, np.array([len(r) for r in pairs.refs]),
                             batch_size, bsw.LANES)
    assert [(c.name, c.n, c.span, c.root) for c in counts] == [
        ("bsw.pairs", n, root.id, root.id),
        ("bsw.groups", len(groups), root.id, root.id)]
    if shards == 2:
        np.testing.assert_array_equal(
            out, bsw.bsw_batch(pairs, batch_size=batch_size, device="cpu"))


@pytest.mark.parametrize("scoring", SCORINGS, ids=["bwa", "narrow"])
@pytest.mark.parametrize("n,batch_size,ambiguous", [
    (96, 512, False), (130, 64, True)])
def test_the_scores_equal_the_reference(scoring, n, batch_size, ambiguous):
    """The port's scores (its plain version, CPU tensors), the
    reference's and the JAX package's, on one slice and on slices of 64
    with two ambiguous bases, exactly."""
    batch = extension_batch(7 + n, n, batch_size)
    pairs = port_pairs(batch, ambiguous)
    got = bsw.bsw_batch(pairs, batch_size=batch_size, device="cpu",
                        **scoring)
    cfg = dict(CONFIG, batch_size=batch_size, **scoring)
    want = reference.solve(as_reference_batch(batch, pairs), cfg)
    assert len(want) == len(batch) == -(-n // batch_size)
    np.testing.assert_array_equal(got, np.concatenate([w[0] for w in want]))
    jax = jbsw.bsw_batch(
        JaxPairs(pairs.h0, [r.astype(np.uint16) for r in pairs.refs],
                 [q.astype(np.uint16) for q in pairs.quers]),
        batch_size=batch_size, backend="xla", **scoring)
    np.testing.assert_array_equal(jax, np.concatenate([w[0] for w in want]))
