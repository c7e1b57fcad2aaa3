"""The port's chain reader, window starts, writer and batching against
the JAX package's, field for field and byte for byte."""

import io

import numpy as np
import pytest

from genarchbench_tpu.io import chain_io as jax_chain_io
from genarchbench_tpu.sharding import batching as jax_batching
from genarchbench_tpu_torch.io import chain_io
from genarchbench_tpu_torch.sharding import batching
from tests.synth import gen_chain_input
from tests.torch_chain_inputs import chain_text, straddling_x


def extra_records(rng):
    """Records the generator does not make: none and one anchor, x above
    2^63, low words straddling 2^31 and 2^32, a many-digit avg."""
    y = (np.uint64(15) << np.uint64(32)) | np.arange(1, 41, dtype=np.uint64)
    big = np.uint64(2**64 - 10**6) + np.arange(0, 400, 10, dtype=np.uint64)
    return [(20.5, 5000, 5000, 500, 1, [], []),
            (13.25, 5000, 5000, 500, 1, [77], [int(y[0])]),
            (31.123456789, 5000, 4000, 300, 2, big, y | (np.uint64(1) << 48)),
            (17.0, 5000, 5000, 500, 1, straddling_x(rng, 2**31, 40), y),
            (22.0, 3000, 5000, 500, 1, straddling_x(rng, 2**32, 40), y)]


@pytest.fixture
def chain_file(tmp_path):
    rng = np.random.default_rng(11)
    text = gen_chain_input(rng, n_records=12, max_anchors=300, n_segs=2)
    path = tmp_path / "chain.txt"
    path.write_text(text + chain_text(extra_records(rng)))
    return str(path)


def test_records_equal(chain_file):
    ours = chain_io.read_records_path(chain_file)
    theirs = jax_chain_io.read_records_path(chain_file)
    assert len(ours) == len(theirs) == 17
    for a, b in zip(ours, theirs):
        for f in ("n", "avg_qspan", "max_dist_x", "max_dist_y", "bw",
                  "n_segs"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.x.dtype == a.y.dtype == np.uint64
        for f in ("x", "y", "x_lo", "x_hi", "qi", "q_span", "sid"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


@pytest.mark.parametrize("max_iter", [5000, 7])
def test_window_starts(chain_file, max_iter):
    """The C sweep against the numpy plain version and the JAX package."""
    ours = chain_io.read_records_path(chain_file)
    theirs = jax_chain_io.read_records_path(chain_file)
    got = chain_io.window_starts_all(ours, max_iter)
    want = jax_chain_io.window_starts_all(theirs, max_iter)
    for r, g, w in zip(ours, got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r.window_starts(max_iter))


def test_write_returns_bytes():
    rng = np.random.default_rng(3)
    res = [(rng.integers(-50, 10**6, n), rng.integers(-1, n, n))
           for n in (0, 1, 17)]
    ours, theirs = io.StringIO(), io.StringIO()
    chain_io.write_returns(ours, res)
    jax_chain_io.write_returns(theirs, res)
    assert ours.getvalue() == theirs.getvalue()
    assert ours.getvalue().startswith("0\nEOR\n1\n")


@pytest.mark.parametrize("budget,max_batch", [(1 << 24, 16384), (1 << 12, 64),
                                              (1 << 8, 4096)])
def test_plan_batches(budget, max_batch):
    lengths = np.random.default_rng(5).integers(0, 700, 300).tolist()
    ours = batching.plan_batches(lengths, cell_budget=budget,
                                 max_batch=max_batch)
    theirs = jax_batching.plan_batches(lengths, cell_budget=budget,
                                       max_batch=max_batch)
    assert [(p.indices, p.length) for p in ours] == \
        [(p.indices, p.length) for p in theirs]
    assert sorted(k for p in ours for k in p.indices) == list(range(300))
