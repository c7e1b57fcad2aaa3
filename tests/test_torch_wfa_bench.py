"""The port's wfa entry as the benchmark reads it, on the CPU: each call
of `wfa_batch` is one `wfa.batch` root tiled by its phase spans, with
the counts of its `stats=`; and each CIGAR, scored as a gap-affine
alignment of its pair, equals the optimal score of the benchmark's
plain reference (`h100_bench/reference/wfa.py`, loaded by path as the
benchmark loads it)."""

import numpy as np
import pytest

from genarchbench_tpu_torch.core import roi
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, encode_dna
from genarchbench_tpu_torch.kernels import wfa
from h100_bench.generators.pairs import PairBatch
from h100_bench.harness.cell import BENCH_DIR, load_module
from tests.synth import gen_seqpair_dataset

PHASES = ("prep", "h2d", "forward", "backtrace", "d2h", "cigars")
PENALTIES = [dict(x=4, o=6, e=2), dict(x=3, o=5, e=1)]
# (seed, pairs, length, error rate, max_batch): one chunk; 300 pairs in
# chunks of 256; a cap resume (0.45 error at 120 bases)
CASES = [(11, 24, 96, 0.10, 16384), (12, 300, 40, 0.10, 1),
         (9, 8, 120, 0.45, 16384)]


def seqpairs(seed, n, length, err):
    text = gen_seqpair_dataset(np.random.default_rng(seed), n_pairs=n,
                               length=length, error_rate=err)
    lines = text.split()
    return SeqPairs([encode_dna(s[1:]) for s in lines[0::2]],
                    [encode_dna(s[1:]) for s in lines[1::2]])


def pair_batch(pairs):
    p_offs, t_offs = (np.concatenate([[0], np.cumsum([len(a) for a in s])])
                      for s in (pairs.patterns, pairs.texts))
    return PairBatch(np.ones(len(pairs), np.int64), p_offs, t_offs,
                     np.concatenate(pairs.patterns),
                     np.concatenate(pairs.texts))


def traced(**kwargs):
    """(the CIGARs, the spans and counts the call appended)."""
    _, before = roi.records()
    out = wfa.wfa_batch(device="cpu", **kwargs)
    recs, after = roi.records()
    recs = recs[len(recs) - (after - before):]
    return (out, [r for r in recs if isinstance(r, roi.Span)],
            [r for r in recs if isinstance(r, roi.Count)])


@pytest.mark.parametrize("seed,n,length,err,max_batch", CASES)
def test_a_call_is_one_root_tiled_by_its_phases(seed, n, length, err,
                                                max_batch):
    pairs = seqpairs(seed, n, length, err)
    stats = {}
    _, spans, counts = traced(pairs=pairs, stats=stats, max_batch=max_batch)
    roots = [s for s in spans if s.parent == 0]
    assert [r.name for r in roots] == ["wfa.batch"]
    root = roots[0]
    assert all(s.root == root.id for s in spans)
    children = sorted((s for s in spans if s.parent == root.id),
                      key=lambda s: s.t0)
    assert len(children) == len(spans) - 1       # no span below a phase
    for a, b in zip(children, children[1:]):
        assert root.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= root.t1
    chunks = stats["chunks"]
    assert chunks == (2 if n == 300 else 1)
    names = [s.name for s in children]
    assert names == ["wfa.prep"] + [f"wfa.{p}" for p in PHASES] * chunks
    total = {}
    for c in counts:
        assert c.root == c.span == root.id
        total[c.name] = total.get(c.name, []) + [c.n]
    assert {k: (len(v), sum(v)) for k, v in total.items()} == {
        "wfa.score_steps": (chunks, stats["score_steps"]),
        "wfa.lane_steps": (chunks, stats["lane_steps"]),
        "wfa.resumes": (chunks, stats["resumes"]),
        "wfa.bt_steps": (chunks, stats["bt_steps"])}
    if chunks == 1:   # the lock-step loop runs every lane every step
        assert stats["lane_steps"] == stats["score_steps"] * n
    if err == 0.45:
        assert stats["resumes"] >= 1


def test_counts_without_stats_are_those_with():
    pairs = seqpairs(12, 300, 40, 0.10)
    out, _, counts = traced(pairs=pairs, max_batch=1)
    stats = {}
    out2, _, counts2 = traced(pairs=pairs, max_batch=1, stats=stats)
    assert out == out2
    assert [(c.name, c.n) for c in counts] == \
        [(c.name, c.n) for c in counts2]


@pytest.mark.parametrize("pen", PENALTIES, ids=["x4o6e2", "x3o5e1"])
@pytest.mark.parametrize("seed,n,length,err", [
    (21, 64, 96, 0.10), (22, 48, 100, 0.20), (23, 32, 60, 0.02),
    (9, 8, 120, 0.45)])
def test_each_cigar_scores_the_reference_optimum(seed, n, length, err, pen):
    reference = load_module(BENCH_DIR / "reference" / "wfa.py")
    adapter = load_module(BENCH_DIR / "adapters" / "wfa.py")
    pairs = seqpairs(seed, n, length, err)
    stats = {}
    cigars = wfa.wfa_batch(pairs, device="cpu", stats=stats, **pen)
    want = reference.scores(pair_batch(pairs), **pen)
    got = [adapter.cigar_score(c, p.tobytes(), t.tobytes(), **pen)
           for c, p, t in zip(cigars, pairs.patterns, pairs.texts)]
    assert got == want.tolist()
    if err == 0.45:
        assert stats["resumes"] >= 1
