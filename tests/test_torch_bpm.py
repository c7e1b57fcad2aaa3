"""The PyTorch port's bpm path against the JAX package, on the CPU.

Every comparison is exact: distances and scores are integers and no
float enters the DP.  The port runs its plain PyTorch versions here
(CPU tensors); the CUDA kernel is held against the same plain version
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from genarchbench_tpu.io.seqpair_io import read_seqpairs as jax_read
from genarchbench_tpu.kernels import bpm as jbpm
from genarchbench_tpu.kernels.bpm_pallas import bpm_distance_pallas
from genarchbench_tpu_torch.convert import bpm_inputs_from_jax
from genarchbench_tpu_torch.io.seqpair_io import SeqPairs, read_seqpairs
from genarchbench_tpu_torch.kernels import bpm, bpm_cuda
from tests.synth import gen_seqpair_dataset

# tests/test_bpm.py's datasets: (seed, pairs, length, error rate)
DATASETS = [
    (0, 50, 100, 0.05),
    (1, 40, 100, 0.30),     # high error rate
    (2, 30, 300, 0.10),     # multi-word patterns
    (3, 20, 20, 0.50),      # short, heavy edits
]


def write_pairs(tmp_path, seed, n, length, err):
    path = tmp_path / "pairs.txt"
    path.write_text(gen_seqpair_dataset(np.random.default_rng(seed),
                                        n_pairs=n, length=length,
                                        error_rate=err))
    return str(path)


def jax_device_calls(monkeypatch, pairs):
    """The (peq, plen, text, tlen, W) arguments and results of every
    `_bpm_distance_device` call that the JAX bpm_batch makes."""
    calls = []
    orig = jbpm._bpm_distance_device

    def record(peq, plen, text, tlen, W):
        out = orig(peq, plen, text, tlen, W)
        calls.append(((np.asarray(peq), np.asarray(plen), np.asarray(text),
                       np.asarray(tlen)), np.asarray(out)))
        return out

    monkeypatch.setattr(jbpm, "_bpm_distance_device", record)
    jbpm.bpm_batch(pairs, backend="xla")
    return calls


@pytest.mark.parametrize("W", [1, 2, 5])
def test_compile_peq_equal(W):
    rng = np.random.default_rng(W)
    pats = [rng.integers(0, 5, int(rng.integers(1, 32 * W + 1))).astype(np.uint8)
            for _ in range(17)]
    np.testing.assert_array_equal(bpm.compile_peq(pats, W),
                                  jbpm.compile_peq(pats, W))


@pytest.mark.parametrize("seed,n,length,err", DATASETS)
def test_plain_matches_xla_device(monkeypatch, tmp_path, seed, n, length, err):
    """The plain version on the JAX package's own DP inputs, converted."""
    pairs = jax_read(write_pairs(tmp_path, seed, n, length, err),
                     swap_longer_first=True)
    calls = jax_device_calls(monkeypatch, pairs)
    assert calls
    for args, want in calls:
        got = bpm_cuda.bpm_distance(*bpm_inputs_from_jax(*args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret(tmp_path):
    """tests/test_bpm.py's Pallas case, the kernel run interpreted."""
    pairs = jax_read(write_pairs(tmp_path, 9, 30, 90, 0.15),
                     swap_longer_first=True)
    for idx, (peq, plen, text, tlen) in bpm.kernel_inputs(pairs):
        W = peq.shape[0]
        jax_peq = peq.view(np.uint32).transpose(2, 0, 1)
        jax_text = text.T.astype(np.int32)
        want = bpm_distance_pallas(jax_peq, plen, jax_text, tlen, W,
                                   interpret=True)
        got = bpm_cuda.bpm_distance(
            *bpm_inputs_from_jax(jax_peq, plen, jax_text, tlen))
        np.testing.assert_array_equal(got.numpy(), want)


def test_plain_uint32_edges():
    """A pattern whose last row is bit 31 (the sign bit of an int32),
    an empty text and N codes, against the JAX device function."""
    rng = np.random.default_rng(4)
    pats = [rng.integers(0, 4, m).astype(np.uint8) for m in (64, 33, 63, 50)]
    texts = [rng.integers(0, 5, m).astype(np.uint8) for m in (40, 70, 0, 9)]
    W = 2
    peq = jbpm.compile_peq(pats, W)
    plen = np.array([len(p) for p in pats], np.int32)
    tlen = np.array([len(t) for t in texts], np.int32)
    text = np.zeros((len(pats), 80), np.int32)
    for b, t in enumerate(texts):
        text[b, :len(t)] = t
    want = np.asarray(jbpm._bpm_distance_device(peq, plen, text, tlen, W))
    got = bpm_cuda.bpm_distance(*bpm_inputs_from_jax(peq, plen, text, tlen))
    np.testing.assert_array_equal(got.numpy(), want)


STEPS = 4      # text steps a lane advances per iteration (csrc/bpm.cu kU)
POPC4 = np.array([bin(v).count("1") for v in range(16)], np.int64)


def wavefront_model(peq, plen, text, tlen):
    """numpy model of csrc/bpm.cu's wavefront schedule (W <= 32), on the
    kernel's inputs.  A pair takes a segment of S = segment_width(W)
    lanes of a 32-lane warp, and lane w holds word w.  At iteration k
    lane w advances text steps STEPS*(k-w) .. STEPS*(k-w)+STEPS-1, with
    the carries and the text codes that lane w-1 sent one iteration
    earlier (one shuffle up, width S, of ph bits | mh bits << 4 | code
    nibbles << 8); a segment's lane 0 takes PHin = 1, MHin = 0 and reads
    the codes.  Steps past the text run too, on what the text tensor
    holds there; the lane of word W-1 counts only the bits of the steps
    below tlen."""
    W, _, B = peq.shape
    T = text.shape[0]
    S = bpm_cuda.segment_width(W)
    assert S >= W
    P = 32 // S                                   # pairs a warp
    nwarp = -(-B // P)
    lane = np.arange(32)
    w = np.broadcast_to(lane % S, (nwarp, 32))
    b = np.arange(nwarp)[:, None] * P + lane // S
    valid = b < B
    bs = np.where(valid, b, 0)
    tl = np.where(valid, np.minimum(tlen[bs], T), 0)
    maxtl = tl.max(axis=1, keepdims=True)
    iters = np.where(maxtl > 0, -(-maxtl // STEPS) + W - 1, 0)
    eq = peq.view(np.uint32)[np.minimum(w, W - 1), :, bs]   # (nwarp, 32, 4)
    eq = np.where((valid & (w < W))[..., None], eq, np.uint32(0))
    eq = np.concatenate([eq, np.zeros((nwarp, 32, 1), np.uint32)], axis=2)
    pl = np.where(valid, plen[bs], 1)
    mask = np.where(w == W - 1,
                    np.uint32(1) << ((pl - 1) % 32).astype(np.uint32),
                    np.uint32(1 << 31)).astype(np.uint32)
    codes = np.minimum(text.view(np.uint8), 4).astype(np.uint32)
    pv = np.full((nwarp, 32), 0xFFFFFFFF, np.uint32)
    mv = np.zeros((nwarp, 32), np.uint32)
    send = np.zeros((nwarp, 32), np.uint32)
    score = pl.astype(np.int64)
    one = np.uint32(1)
    for k in range(int(iters.max(initial=0))):
        recv = np.where(w > 0, np.roll(send, 1, axis=1), send)
        first = np.full((nwarp, 32), 0xF, np.uint32)
        for u in range(STEPS):
            t = k * STEPS + u
            c = np.where(valid & (t < T), codes[min(t, T - 1), bs],
                         0).astype(np.uint32)
            first |= c << np.uint32(8 + 4 * u)
        recv = np.where(w == 0, first, recv)
        t0 = (k - w) * STEPS
        act = (w < W) & (t0 >= 0) & (t0 < tl) & (k < iters)
        bits = np.zeros((nwarp, 32), np.uint32)
        npv, nmv = pv, mv
        for u in range(STEPS):
            code = (recv >> np.uint32(8 + 4 * u)) & np.uint32(15)
            e = np.take_along_axis(eq, code[..., None].astype(np.int64),
                                   axis=2)[..., 0]
            ph_in = (recv >> np.uint32(u)) & one
            mh_in = (recv >> np.uint32(4 + u)) & one
            xv = e | nmv
            e_ = e | mh_in
            xh = (((e_ & npv) + npv) ^ npv) | e_
            ph = nmv | ~(xh | npv)
            mh = npv & xh
            bits |= (((ph & mask) != 0).astype(np.uint32) << np.uint32(u)
                     | ((mh & mask) != 0).astype(np.uint32)
                     << np.uint32(4 + u))
            ph = (ph << one) | ph_in
            mh = (mh << one) | mh_in
            npv = mh | ~(xv | ph)
            nmv = ph & xv
        pv = np.where(act, npv, pv)
        mv = np.where(act, nmv, mv)
        send = np.where(act, bits | (recv & np.uint32(0xFFFF00)), send)
        m = (1 << np.clip(tl - t0, 0, STEPS)) - 1
        score += np.where(act, POPC4[bits & m] - POPC4[(bits >> 4) & m], 0)
    out = np.zeros(B, np.int64)
    last = valid & (w == W - 1)
    out[b[last]] = score[last]
    return out


def uint32_edge_inputs():
    """test_plain_uint32_edges' pairs in the port's layout: a pattern
    whose last row is bit 31, an empty text and N codes."""
    rng = np.random.default_rng(4)
    pats = [rng.integers(0, 4, m).astype(np.uint8) for m in (64, 33, 63, 50)]
    texts = [rng.integers(0, 5, m).astype(np.uint8) for m in (40, 70, 0, 9)]
    return [a for _, a in bpm.kernel_inputs(SeqPairs(pats, texts))]


def mixed_inputs():
    """Every segment width, several pairs a warp, text lengths 0..90
    mixed inside a warp and patterns ending on bit 31."""
    rng = np.random.default_rng(12)
    plens = [n for W in (1, 2, 3, 4, 5, 9, 16, 17, 32) for n in
             [32 * W] + list(rng.integers(32 * (W - 1) + 1, 32 * W + 1, 6))]
    pats = [rng.integers(0, 5, int(n)).astype(np.uint8) for n in plens]
    tl = rng.integers(0, 91, len(plens))
    tl[::4] = 0
    texts = [rng.integers(0, 5, int(m)).astype(np.uint8) for m in tl]
    return [a for _, a in bpm.kernel_inputs(SeqPairs(pats, texts))]


@pytest.mark.parametrize("case", [f"dataset{k}" for k in range(len(DATASETS))]
                         + ["uint32_edges", "mixed"])
def test_wavefront_model_matches_plain(tmp_path, case):
    """The wavefront schedule of the CUDA kernel, modelled in numpy, gives
    the plain version's distances exactly: the carries of word w at steps
    t .. t+3 are taken from lane w-1 one iteration after it made them."""
    if case.startswith("dataset"):
        path = write_pairs(tmp_path, *DATASETS[int(case[7:])])
        groups = [a for _, a in bpm.kernel_inputs(
            read_seqpairs(path, swap_longer_first=True))]
    else:
        groups = uint32_edge_inputs() if case == "uint32_edges" else mixed_inputs()
    for peq, plen, text, tlen in groups:
        want = bpm_cuda.bpm_distance_plain(*(torch.from_numpy(a) for a in
                                             (peq, plen, text, tlen)))
        np.testing.assert_array_equal(wavefront_model(peq, plen, text, tlen),
                                      want.numpy())


@pytest.mark.parametrize("W,S", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                 (8, 8), (9, 16), (16, 16), (17, 32),
                                 (32, 32), (33, 0), (0, 0)])
def test_segment_width(W, S):
    assert bpm_cuda.segment_width(W) == S


@pytest.mark.parametrize("seed,n,length,err", DATASETS[:2] + [
    (9, 60, None, 0.2)])          # tests/test_bpm.py's mixed lengths
def test_bpm_batch_matches_jax(tmp_path, seed, n, length, err):
    if length is None:
        rng = np.random.default_rng(seed)
        path = tmp_path / "pairs.txt"
        path.write_text("".join(
            gen_seqpair_dataset(rng, n_pairs=10, length=L, error_rate=err)
            for L in (10, 64, 65, 128, 200, 500)))
        path = str(path)
    else:
        path = write_pairs(tmp_path, seed, n, length, err)
    before = bpm_cuda.LAUNCHES
    got = bpm.bpm_batch(read_seqpairs(path, swap_longer_first=True),
                        device="cpu")
    want = jbpm.bpm_batch(jax_read(path, swap_longer_first=True),
                          backend="xla")
    np.testing.assert_array_equal(got, want)
    assert bpm_cuda.LAUNCHES == before      # CPU tensors launch no kernel


@pytest.mark.parametrize("alg,seed,n,length,err", [
    ("bitpal-edit", 0, 32, 100, 0.1),
    ("bitpal-edit", 1, 24, 300, 0.25),
    ("bitpal-scored", 2, 32, 100, 0.1),
    ("bitpal-scored", 3, 24, 300, 0.25),
])
def test_bitpal_batch_matches_jax(tmp_path, alg, seed, n, length, err):
    sc = (0, -1, -1) if alg == "bitpal-edit" else (1, -4, -2)
    path = write_pairs(tmp_path, seed, n, length, err)
    got = bpm.bitpal_batch(read_seqpairs(path, swap_longer_first=True), *sc,
                           device="cpu")
    want = jbpm.bitpal_batch(jax_read(path, swap_longer_first=True), *sc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alg", ["bpm-edit", "bitpal-scored"])
def test_run_output_matches_jax(monkeypatch, tmp_path, alg):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    path = write_pairs(tmp_path, 2, 30, 300, 0.10)
    ours, theirs = tmp_path / "torch.out", tmp_path / "jax.out"
    assert bpm.run(["-a", alg, "-i", path, "-o", str(ours)]) == 0
    assert jbpm.run(["-a", alg, "-i", path, "-o", str(theirs)]) == 0
    assert (sorted(ours.read_text().splitlines())
            == sorted(theirs.read_text().splitlines()))
