"""The port's poa graph, on the CPU: its C graph (native/poa_graph.c)
against its plain Python `Graph` and against the JAX package's C graph,
after the same walks, all exact: rank order, the six DP export arrays,
the widest in-degree and the consensus after every read."""

import numpy as np
import pytest

from genarchbench_tpu import native as jax_native
from genarchbench_tpu.kernels import poa as J
from genarchbench_tpu_torch.kernels import poa as T
from tests import torch_poa_inputs as I

PEN = (-6, -2, -28, -1)          # g, e, q, c of the default engine


def state(graph):
    """Everything the DP and `consensus_for_batches` read from a graph."""
    P = max(graph.max_in_edges(), 1)
    return (np.asarray(graph.rank_ids(), np.int64).tolist(),
            graph.max_in_edges(), graph.export_dp(P, *PEN),
            graph.generate_consensus())


def assert_same(graphs, what):
    (r0, p0, ex0, c0), *rest = [state(g) for g in graphs]
    for k, (r, p, ex, c) in enumerate(rest, 1):
        assert r == r0, f"{what}: rank order of graph {k}"
        assert p == p0, f"{what}: max_in_edges of graph {k}"
        for name, a, b in zip(("codes", "preds", "npred", "endmask", "O0",
                               "F0"), ex, ex0):
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"{what}: export_dp {name} of graph {k}"
        assert c == c0, f"{what}: consensus of graph {k}"
    return p0


def three_graphs():
    return [T.NativeGraph(), T.Graph(),
            J.NativeGraph(jax_native.readers_lib())]


@pytest.mark.parametrize("n_reads,length,err,min_in", [
    (6, 60, 0.08, 1),
    (14, 50, 0.35, 5),             # a node with 5 or more in-edges
    (5, 30, 0.0, 1),               # identical reads
], ids=["noisy", "wide", "identical"])
def test_graphs_agree_after_walks(n_reads, length, err, min_in):
    """Each read's walk is the port's engine's over the port's C graph;
    the same walk then goes into all three graphs."""
    rng = np.random.default_rng(n_reads)
    text = I.batches_text(rng, (n_reads,), length, err)
    reads = text.splitlines()[1::2]
    engine = T.ConvexNWEngine(device="cpu")
    graphs = three_graphs()
    widest = 0
    for s, seq in enumerate(reads):
        walk = engine.align_many([seq], [graphs[0]])[0]
        for g in graphs:
            g.add_walk(walk, seq)
        widest = max(widest, assert_same(graphs, f"read {s}"))
    assert widest >= min_in


def test_empty_walks_and_reads():
    """No walk (an empty graph), an empty walk (a read aligned to
    nothing: a disjoint chain) and an empty read (no change)."""
    graphs = three_graphs()
    empty = (np.zeros(0, np.int16), np.zeros(0, np.int16))
    for walk, seq in ((None, "ACGTTGCA"), (empty, "TTGACC"), (None, ""),
                      (empty, "GATTACA")):
        for g in graphs:
            g.add_walk(walk, seq)
        assert_same(graphs, f"{seq!r}")
    assert graphs[0].num_ranks() == 8 + 6 + 7


def test_new_graph_is_the_c_graph():
    g = T.new_graph()
    assert isinstance(g, T.NativeGraph) and g.num_ranks() == 0
    assert g.generate_consensus() == ""


def test_malformed_walk_raises():
    """A walk that consumes no query base is refused by the C graph."""
    g = T.NativeGraph()
    g.add_walk(None, "ACGT")
    with pytest.raises(RuntimeError, match="poa_add_alignment"):
        g.add_walk((np.array([1, 2], np.int16), np.array([-1, -1], np.int16)),
                   "AC")
    with pytest.raises(ValueError, match="walk halves"):
        g.add_walk((np.array([1, 2], np.int16), np.array([0], np.int16)),
                   "AC")
