"""The PyTorch port's readers against the JAX package's, array for array."""

import numpy as np
import pytest

from genarchbench_tpu.io import bsw_io as jax_bsw_io
from genarchbench_tpu.io import seqpair_io as jax_seqpair_io
from genarchbench_tpu_torch.io import bsw_io, seqpair_io
from tests.synth import gen_bsw_input, gen_seqpair_dataset


@pytest.mark.parametrize("swap", [False, True])
def test_seqpairs_equal(tmp_path, swap):
    rng = np.random.default_rng(0)
    text = gen_seqpair_dataset(rng, n_pairs=40, length=70, error_rate=0.3)
    # lower case, N and other letters encode as in the reference
    text += ">acgtNNRY\n<ACG\n>A\n<TTTTACGT\n"
    path = tmp_path / "pairs.txt"
    path.write_text(text)
    ours = seqpair_io.read_seqpairs(str(path), swap_longer_first=swap)
    theirs = jax_seqpair_io.read_seqpairs(str(path), swap_longer_first=swap)
    assert len(ours) == len(theirs) == 42
    for a, b in zip(ours.patterns + ours.texts,
                    theirs.patterns + theirs.texts):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_bsw_pairs_equal(tmp_path):
    rng = np.random.default_rng(1)
    text = gen_bsw_input(rng, n_pairs=30, ref_len=150, query_len=60)
    text += "7\n01234\n4\n"                  # ambiguous bases
    path = tmp_path / "pairs.txt"
    path.write_text(text)
    ours = bsw_io.read_bsw_pairs(str(path))
    theirs = jax_bsw_io.read_bsw_pairs(str(path))
    assert len(ours) == len(theirs) == 31
    assert ours.h0.dtype == np.int32
    np.testing.assert_array_equal(ours.h0, theirs.h0)
    for a, b in zip(ours.refs + ours.quers, theirs.refs + theirs.quers):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert list(ours.refs[-1]) == [0, 1, 2, 3, 0xFFFF]
