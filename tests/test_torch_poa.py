"""The port's poa path against the JAX package, on the CPU, all exact.

The DP's code planes and start rows against `_convex_dp_codes` under
`jax.vmap`, and the walks against `_poa_align_device`, on random rounds
at P = 1, 2, 4 and 8, in the closed-form regime and under the general
max-plus scan (g=-6, e=-4, q=-2, c=-1, where q > e); the walks again on
the rounds the JAX engine dispatched, split by
`convert.poa_round_from_jax`; blocks of 7 and longer than the graph
against the default; consensus strings and `cli run poa`'s stdout byte
for byte against the JAX `poa.run`.  The JAX package's C graph serves
its engine, as in a JAX run.
"""

import ast
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genarchbench_tpu.kernels import poa as J
from genarchbench_tpu_torch import cli, convert
from genarchbench_tpu_torch.kernels import poa as T
from tests import torch_poa_inputs as I

REPO = pathlib.Path(__file__).resolve().parent.parent
CLOSED = (2, -4, -6, -2, -28, -1)       # m, n, g, e, q, c (the defaults)
GENERAL = (2, -4, -6, -4, -2, -1)       # -o 2,1 -e 4,1
FLAGS = {"default": [], "closed": ["-m", "3", "-x", "5", "-o", "3,20",
                                   "-e", "1,1"],
         "general": ["-o", "2,1", "-e", "4,1"]}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")


def jax_round(arrays, nrows, R, W, P, pen):
    """The JAX DP's planes and start rows (vmapped `_convex_dp_codes`) and
    its walks (`_poa_align_device` on the same round's blob)."""
    m, n, g, e, q, c = pen
    dp = jax.jit(jax.vmap(partial(J._convex_dp_codes, R=R, W=W, P=P, m=m,
                                  n=n, g=g, e=e, q=q, c=c),
                          in_axes=(0,) * 9 + (None,)))
    args = [jnp.asarray(arrays[k]) for k in I.ROUND]
    p1, p2, start = dp(*args, jnp.int32(nrows))
    walks = jax_walks(I.jax_blob(arrays), R, W, P, pen)
    return (np.asarray(p1).view(np.int32), np.asarray(p2).view(np.int32),
            np.asarray(start), *walks)


def jax_walks(blob, R, W, P, pen):
    m, n, g, e, q, c = pen
    packed = np.asarray(J._poa_align_device(
        jnp.asarray(blob), R=R, W=W, P=P, m=m, n=n, g=g, e=e, q=q, c=c,
        MAXSTEP=R + W + 5))
    return unpack(packed)


def unpack(packed):
    """JAX's packed int32 walk words -> (outi, outj) int16."""
    packed = np.asarray(packed, np.int32)
    return ((packed & 0xFFFF).astype(np.uint16).view(np.int16),
            (packed >> 16).astype(np.int16))


def port_round(t, nrows, pen, block=T.BLOCK):
    """The port's DP and walk on tensors t by name: (plane1, plane2,
    start_i, outi, outj) as numpy arrays."""
    args = [t[k] for k in I.ROUND]
    planes, start = T._convex_dp_rows(*args, nrows, pen, block)
    R, W1 = t["node_ch"].shape[1], t["seq"].shape[1]
    outi, outj = T._poa_walk(planes, start, t["Wlen"], R + W1 + 4, block)
    return [x.numpy() for x in (planes[:, :R + 1, 0], planes[:, :R + 1, 1],
                                start, outi, outj)]


def tensors(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def assert_round_equal(got, want, nrows):
    names = ("plane1", "plane2", "start_i", "outi", "outj")
    for name, a, b in zip(names, got, want):
        if name.startswith("plane"):      # rows past nrows are padding
            a, b = a[:, :nrows + 1], b[:, :nrows + 1]
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.mark.parametrize("pen", [CLOSED, GENERAL], ids=["closed", "general"])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_dp_rows_and_walks(P, pen):
    rng = np.random.default_rng(P)
    R, W = 24, 20
    arrays, nrows = I.random_round(rng, 3, R, W, P, pen)
    assert (arrays["npred"] == P).any() and arrays["endmask"].any()
    want = jax_round(arrays, nrows, R, W, P, pen)
    got = port_round(tensors(arrays), nrows, pen)
    assert_round_equal(got, want, nrows)
    # the walks used each kind of move
    steps = got[3][got[3] > -2]
    assert (steps == -1).any() and (steps > 0).any()


@pytest.mark.parametrize("block", [7, 64])
def test_blocks(block):
    """Blocks of 7 rows (a ragged last block) and one block longer than
    the graph give the default's planes, start rows and walks."""
    rng = np.random.default_rng(11)
    arrays, nrows = I.random_round(rng, 4, 30, 25, 4, CLOSED)
    assert nrows % 7 and nrows < 64
    t = tensors(arrays)
    assert_round_equal(port_round(t, nrows, CLOSED, block),
                       port_round(t, nrows, CLOSED), nrows)


def test_start_row_ties():
    """Every rank of window 0 a source of one character, all end rows:
    their H rows are equal, and the first in rank order starts the walk,
    as the reference's strict max keeps it."""
    m, n, g, e, q, c = CLOSED
    rng = np.random.default_rng(3)
    arrays, nrows = I.random_round(rng, 2, 12, 10, 2, CLOSED, pad_lanes=0)
    arrays["node_ch"][0] = ord("A")
    arrays["preds"][0] = 0
    arrays["npred"][0] = 1
    arrays["endmask"][0] = True
    arrays["O0col"][0, 1:] = q
    arrays["F0col"][0, 1:] = g
    arrays["H0col"][0, 1:] = max(q, g)
    got = port_round(tensors(arrays), nrows, CLOSED)
    assert got[2][0] == 1
    assert_round_equal(got, jax_round(arrays, nrows, 12, 10, 2, CLOSED),
                       nrows)


def recorded_rounds(text, tmp_path):
    seq = tmp_path / "seq.fa"
    seq.write_text(text)
    batches = J.read_batches(str(seq))
    rounds = []
    orig = J._poa_align_device

    def record(blob, **kw):
        out = orig(blob, **kw)
        rounds.append((np.asarray(blob), kw, np.asarray(out)))
        return out

    J._poa_align_device = record
    try:
        cons = J.consensus_for_batches(batches, J.ConvexNWEngine())
    finally:
        J._poa_align_device = orig
    return batches, cons, rounds


def test_walks_on_the_jax_engines_rounds(tmp_path):
    """Each round the JAX engine dispatched, its blob split by
    `convert.poa_round_from_jax`, through the port's DP and walk: the
    same walks word for word (JAX's pad lanes included)."""
    text = I.batches_text(np.random.default_rng(5), (6, 6, 4), 70, 0.12)
    batches, cons, rounds = recorded_rounds(text, tmp_path)
    assert len(rounds) >= 5 and {kw["P"] for _, kw, _ in rounds} >= {1, 2}
    for blob, kw, out in rounds:
        t = convert.poa_round_from_jax(blob, kw["R"], kw["W"], kw["P"])
        nrows = int((t["node_ch"] >= 0).sum(1).max())
        pen = tuple(kw[k] for k in "mngeqc")
        got = port_round(t, nrows, pen)
        wi, wj = unpack(out)
        n = wi.shape[1]
        assert np.array_equal(got[3][:, :n], wi)
        assert np.array_equal(got[4][:, :n], wj)
        assert (got[3][:, n:] == -2).all()
    port = T.consensus_for_batches(batches, T.ConvexNWEngine(device="cpu"))
    assert port == cons


def test_convert_round_layout():
    arrays, _ = I.random_round(np.random.default_rng(2), 3, 9, 7, 2, CLOSED)
    t = convert.poa_round_from_jax(I.jax_blob(arrays), 9, 7, 2)
    assert list(t) == list(I.ROUND)
    for k in I.ROUND:
        assert np.array_equal(t[k].numpy(), arrays[k]), k
    assert t["endmask"].dtype == torch.bool
    with pytest.raises(ValueError, match="whole number"):
        convert.poa_round_from_jax(I.jax_blob(arrays)[:-1], 9, 7, 2)


def run_both(text, tmp_path, capsys, flags=()):
    """`cli run poa` (the port, on the CPU) and the JAX `poa.run` on one
    input: (port stdout, port stderr, JAX stdout)."""
    seq = tmp_path / "seq.fa"
    seq.write_text(text)
    assert cli.main(["run", "poa", "-s", str(seq), *flags]) == 0
    port = capsys.readouterr()
    assert J.run(["-s", str(seq), *flags]) == 0
    return port.out, port.err, capsys.readouterr().out


@pytest.mark.parametrize("flags", list(FLAGS), ids=list(FLAGS))
def test_cli_matches_jax(flags, tmp_path, capsys):
    text = I.batches_text(np.random.default_rng(7), (5, 7, 6), 60, 0.1)
    out, err, want = run_both(text, tmp_path, capsys, FLAGS[flags])
    assert out == want
    assert out.count(">Consensus_sequence\n") == 3
    lines = err.splitlines()
    assert lines[:2] == ["Running with threads: 1",
                         "Number of batches: 3, Size of batch struct 64"]
    assert lines[2].startswith("Runtime: ") and ", GraphCreate: 0.00, " \
        in lines[2]


def test_identical_reads(tmp_path, capsys):
    """Every DP cell ties (test_poa.py:82-86's input)."""
    text = "s0_0\nACGTACGTGG\ns1_1\nACGTACGTGG\ns1_2\nACGTACGTGG\n"
    out, _, want = run_both(text, tmp_path, capsys)
    assert out == want == ">Consensus_sequence\nACGTACGTGG\n"


def test_uneven_windows_and_empty_reads(tmp_path, capsys):
    """Windows of 1 to 7 reads, an empty first read and an empty read
    inside a window, so rounds hold different window sets."""
    text = I.batches_text(np.random.default_rng(8), (3, 7, 1, 5, 4), 50,
                          0.1, empty={(1, 2), (3, 0), (4, 3)})
    out, _, want = run_both(text, tmp_path, capsys)
    assert out == want and out.count(">") == 5


def test_consensus_for_batches_and_stats():
    batches = [I.batches_text(np.random.default_rng(9), (n,), 40, 0.1)
               .splitlines()[1::2] for n in (4, 6, 2)]
    stats = {}
    engine = T.ConvexNWEngine(device="cpu")
    port = T.consensus_for_batches(batches, engine, stats)
    assert port == J.consensus_for_batches(batches, J.ConvexNWEngine())
    assert T.consensus_for_batch(batches[0], engine) == port[0]
    assert stats["rounds"] == 6 and stats["dispatches"] >= 5
    assert stats["windows"] == 3 + 2 + 2 + 1 + 1
    assert stats["dp_rows"] % T.BLOCK == 0
    assert stats["walk_steps"] % T.BLOCK == 0
    assert 0 < stats["cells"] <= stats["pred_cells"]
    assert stats["cells"] < stats["dp_cells"]
    for k in ("export_s", "prep_s", "h2d_s", "dp_s", "walk_s", "d2h_s",
              "update_s", "consensus_s"):
        assert stats[k] >= 0, k


def test_engine_block_of_7(monkeypatch):
    batches = [I.batches_text(np.random.default_rng(10), (5,), 45, 0.15)
               .splitlines()[1::2]]
    want = T.consensus_for_batches(batches, T.ConvexNWEngine(device="cpu"))
    monkeypatch.setattr(T, "BLOCK", 7)
    assert T.consensus_for_batches(
        batches, T.ConvexNWEngine(device="cpu")) == want


def test_align_path():
    """The single-window wrapper's (node id, query index) path."""
    paths = []
    for engine, graph in ((T.ConvexNWEngine(device="cpu"), T.new_graph()),
                          (J.ConvexNWEngine(), J.new_graph())):
        graph.add_walk(None, "ACGTACGGTA")
        paths.append(engine.align("ACTACGTTA", graph))
    assert paths[0] == paths[1]
    assert (2, -1) in paths[0] and len(paths[0]) >= 10


def test_row_index_refusal():
    """A graph past 1984 ranks (the JAX engine's 64-row padding plus the
    virtual row overflow the 11-bit row fields): both engines refuse."""
    reads = ["ACGT" * 497, "ACGT" * 10]
    for engine in (T.ConvexNWEngine(device="cpu"), J.ConvexNWEngine()):
        cons = T if isinstance(engine, T.ConvexNWEngine) else J
        with pytest.raises(ValueError, match="11-bit row-index budget"):
            cons.consensus_for_batches([reads], engine)


def test_bench_input_matches_bench_py():
    """bench.py:141-161's generator, run from bench.py's own source
    against a stand-in for its output path, against the copy."""
    tree = ast.parse((REPO / "bench.py").read_text())
    block = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                 and ast.unparse(n.test) == "not poa.exists()")

    class Sink:
        text = None

        def write_text(self, s):
            Sink.text = s

    exec(compile(ast.Module(body=block.body, type_ignores=[]), "bench.py",
                 "exec"), {"np": np, "poa": Sink()})
    assert Sink.text == I.bench_input()
    assert Sink.text.count("\n") == 256 * 10 * 2
