"""The port's mesh helpers and collectives on the CPU: JAX's
`test_mesh_helpers` (tests/test_sharding.py) on the port, `shard_args`'
padding and round trips, each collective on 8 CPU shards against numpy,
the k-mer owner mix against a numpy uint64 model, `data_mesh`'s refusal
of cards the host lacks, `init_distributed`'s coordinator contract, the
threads' `Exchange`, and the device guard of the hand kernels' wrappers
and of `run_blocks` (each enters the tensors' card, with a stand-in for
the card, the library and the CUDA runtime: a CPU host has none)."""

import contextlib
import types

import numpy as np
import pytest
import torch

from genarchbench_tpu_torch.core import blocks
from genarchbench_tpu_torch.kernels import bpm_cuda, bsw_cuda
from genarchbench_tpu_torch.kernels.kmer import code_owner
from genarchbench_tpu_torch.sharding import mesh as M


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cpu")
    monkeypatch.delenv("GENARCH_HOSTS", raising=False)
    monkeypatch.delenv("GENARCH_DEVICES", raising=False)


def test_mesh_helpers(monkeypatch):
    m = M.data_mesh(8)
    assert M.mesh_size(m) == 8 and m.devices == (torch.device("cpu"),) * 8
    assert M.data_mesh(1) is None and M.mesh_size(None) == 1
    assert M.pad_batch(5, m) == 8 and M.pad_batch(8, m) == 8
    assert M.pad_batch(9, None) == 9
    monkeypatch.setenv("GENARCH_DEVICES", "4")
    assert M.devices_from_env() == 4 and M.mesh_size(M.data_mesh()) == 4
    monkeypatch.setenv("GENARCH_DEVICES", "lots")
    assert M.devices_from_env() == 1 and M.data_mesh() is None
    a, = M.shard_args(m, np.arange(16.0).reshape(8, 2))
    assert len(a) == 8 and all(t.shape == (1, 2) for t in a)
    assert np.allclose(M.gather_shards(a, 8).numpy(),
                       np.arange(16.0).reshape(8, 2))
    x = np.arange(3)
    assert M.shard_args(None, x) == (x,)


@pytest.mark.parametrize("n,S", [(5, 8), (9, 4), (8, 8), (1, 3), (16, 3)])
def test_shard_args_pads_and_round_trips(n, S):
    m = M.data_mesh(S)
    a = np.arange(n * 3, dtype=np.int64).reshape(n, 3)
    b = torch.arange(n, dtype=torch.int32)
    sa, sb = M.shard_args(m, a, b)
    c = -(-n // S)
    assert [len(t) for t in sa] == [c] * S == [len(t) for t in sb]
    # the padding repeats the last item
    assert np.array_equal(torch.cat(sa).numpy(),
                          a[np.minimum(np.arange(c * S), n - 1)])
    assert np.array_equal(M.gather_shards(sa, n).numpy(), a)
    assert torch.equal(M.gather_shards(sb, n), b)
    ranges = M.shard_ranges(n, m)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(lo <= hi and hi - lo <= c for lo, hi in ranges)
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
    parts = M.shard_items(np.arange(10, 10 + n), m)
    assert np.array_equal(np.concatenate(parts)[:n], np.arange(10, 10 + n))
    with pytest.raises(ValueError, match="leading lengths"):
        M.shard_args(m, a, b[:-1] if n > 1 else torch.zeros(2))


def test_collectives_on_8_shards():
    m = M.data_mesh(8)
    rng = np.random.default_rng(0)
    xs = [rng.integers(-100, 100, (6, 2)) for _ in range(8)]
    ts = [torch.from_numpy(x) for x in xs]
    for got in M.psum(m, ts):
        assert np.array_equal(got.numpy(), sum(xs))
    for got in M.all_gather(m, ts):
        assert np.array_equal(got.numpy(), np.concatenate(xs))
    with pytest.raises(ValueError, match="shapes differ"):
        M.all_gather(m, ts[:7] + [ts[7][:3]])
    big = [rng.integers(0, 50, (16, 3)) for _ in range(8)]
    scat = M.psum_scatter(m, [torch.from_numpy(x) for x in big])
    assert np.array_equal(torch.cat(scat).numpy(), sum(big))
    assert all(s.shape == (2, 3) for s in scat)
    # uneven sends, some empty
    sends = [[torch.from_numpy(rng.integers(0, 9, int(rng.integers(0, 4))))
              for _ in range(8)] for _ in range(8)]
    recv = M.all_to_all(m, sends)
    for i in range(8):
        for g in range(8):
            assert torch.equal(recv[i][g], sends[g][i])
    with pytest.raises(ValueError, match="local shards"):
        M.psum(m, ts[:3])


def owner_model(codes: np.ndarray, S: int) -> np.ndarray:
    """splitmix64's finalizer on uint64, its top 31 bits mod S."""
    x = codes.astype(np.uint64)
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return ((x >> np.uint64(33)) % np.uint64(S)).astype(np.int64)


@pytest.mark.parametrize("S", [2, 3, 8])
def test_owner_mix_against_uint64_model(S):
    rng = np.random.default_rng(S)
    codes = np.concatenate([rng.integers(0, 4 ** 31, 20000, dtype=np.int64),
                            [0, 1, 4 ** 31 - 1, 4 ** 17 - 1]])
    got = code_owner(torch.from_numpy(codes), S).numpy()
    assert np.array_equal(got, owner_model(codes, S))
    counts = np.bincount(got, minlength=S)
    assert counts.min() > 0.9 * len(codes) / S


def test_data_mesh_refuses_missing_cards(monkeypatch):
    monkeypatch.setenv("GENARCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert M.data_mesh(2).devices == (torch.device("cuda", 0),
                                      torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="more cards than this host has"):
        M.data_mesh(4)
    monkeypatch.setenv("GENARCH_DEVICES", "3")
    with pytest.raises(RuntimeError, match=r"has \(2\)"):
        M.data_mesh()
    monkeypatch.setenv("GENARCH_DEVICE", "mps")
    with pytest.raises(ValueError, match="cuda or cpu"):
        M.data_mesh(2)


def test_init_distributed_contract(monkeypatch):
    assert M.init_distributed() == 1
    monkeypatch.setenv("GENARCH_HOSTS", "2")
    monkeypatch.setenv("GENARCH_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("GENARCH_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError, match="GENARCH_PROCESS_ID is not"):
        M.init_distributed()
    with pytest.raises(RuntimeError, match="GENARCH_PROCESS_ID is not"):
        M.global_data_mesh()


def test_exchange_and_threads():
    """Four threads meet in each exchange; one leaves early, one fails
    later: the others go on, and the failure reaches the caller."""
    seen = []
    ex = M.Exchange(4, lambda vals: (seen.append(list(vals)) or
                                     [None if v is None else sum(
                                         w for w in vals if w is not None)
                                      for v in vals]))

    def worker(i, rounds):
        def fn():
            return [ex.exchange(i, i + 1) for _ in range(rounds)]
        return fn

    out = M.run_threads([worker(0, 3), worker(1, 1), worker(2, 3),
                         worker(3, 2)], ex)
    assert out == [[10, 8, 4], [10], [10, 8, 4], [10, 8]]
    assert seen == [[1, 2, 3, 4], [1, None, 3, 4], [1, None, 3, None]]

    ex = M.Exchange(2, lambda vals: vals)

    def bad():
        ex.exchange(1, 0)
        raise KeyError("shard 1")
    with pytest.raises(KeyError, match="shard 1"):
        M.run_threads([lambda: [ex.exchange(0, 0) for _ in range(3)], bad],
                      ex)
    ex = M.Exchange(2, lambda vals: 1 / 0)
    with pytest.raises(RuntimeError, match="combine failed"):
        M.run_threads([lambda: ex.exchange(0, 0),
                       lambda: ex.exchange(1, 0)], ex)


class OnCard:
    """A CPU tensor that says it lies on a card."""

    def __init__(self, t, dev):
        self._t, self.device = t, dev

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's device guard, streams and graphs, and torch.empty on
    a card, stood in for on the CPU; returns the log of (event, the
    current card) pairs."""
    log, current = [], [torch.device("cuda", 0)]

    @contextlib.contextmanager
    def device(dev):
        current.append(torch.device(dev))
        try:
            yield
        finally:
            current.pop()

    class Stream:
        def __init__(self, dev=None):
            self.dev, self.cuda_stream = dev, 0
            log.append(("stream", dev))

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def stream(s):
        yield

    class CUDAGraph:
        def replay(self):
            log.append(("replay", current[-1]))

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode="global"):
        log.append(("capture", current[-1], stream.dev))
        yield

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", stream)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(dev))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            shared_memory_per_block_optin=232448))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        real_empty(*a, **k))

    def launch(name):
        def fn(*args):
            log.append((name, current[-1]))
            return 0
        return fn
    lib = types.SimpleNamespace(genarch_bpm=launch("bpm"),
                                genarch_bsw=launch("bsw"))
    monkeypatch.setattr(bpm_cuda, "_lib", lambda: lib)
    monkeypatch.setattr(bsw_cuda, "_lib", lambda: lib)
    return log


def test_wrappers_enter_the_tensors_card(fake_card):
    card = torch.device("cuda", 1)
    W, B, T = 1, 3, 5
    peq = OnCard(torch.zeros((W, 4, B), dtype=torch.int32), card)
    lens = OnCard(torch.ones(B, dtype=torch.int32), card)
    text = OnCard(torch.zeros((T, B), dtype=torch.int8), card)
    n = bpm_cuda.LAUNCHES
    bpm_cuda.bpm_distance(peq, lens, text, lens)
    assert bpm_cuda.LAUNCHES == n + 1
    assert ("bpm", card) in fake_card and ("stream", card) in fake_card
    G, L = 2, 8
    s1 = OnCard(torch.zeros((G, L, 32), dtype=torch.uint8), card)
    lane = OnCard(torch.ones((G, L), dtype=torch.int32), card)
    bsw_cuda.bsw_scores(s1, s1, lane, lane, lane, lane, match=1,
                        mismatch=-4, ambig=-1, o_del=6, e_del=1, o_ins=6,
                        e_ins=1, zdrop=100, w=100)
    assert ("bsw", card) in fake_card
    assert all(e[1] == card for e in fake_card
               if e[0] in ("bpm", "bsw", "stream"))


def test_run_blocks_enters_the_card(fake_card):
    card = torch.device("cuda", 1)
    calls = []
    ran = blocks.run_blocks(lambda: calls.append(1), 5, True, device=card)
    # one eager block, one captured (it runs at its first replay)
    assert ran == 5 and len(calls) == 2
    assert ("capture", card, card) in fake_card
    assert [e for e in fake_card if e[0] == "replay"] == [("replay", card)] * 4
    assert all(e[1] == card for e in fake_card if e[0] == "stream")
    with pytest.raises(ValueError, match="CUDA device"):
        blocks.run_blocks(lambda: None, 2, True, device=torch.device("cpu"))
    assert blocks.run_blocks(lambda: calls.append(1), 3, False) == 3
