"""The read generator: a seed repeats exactly, its minimizers are the
plain definition's, and a batch follows its traffic file's parameters
and minimap2's anchor layout."""

import json
import pathlib

import numpy as np
import pytest
import torch

from h100_bench.generators import reads

TRAFFIC = pathlib.Path(__file__).resolve().parents[1] / "traffic"
SEED = 2**33 + 5
SMALL = {"batch_bases": 60000, "contigs": [40000, 40000, 40000]}


def traffic(name, **changes):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    t.update(SMALL)
    if name == "ont":
        t.update(length_mean=3000, length_sd=2500)
    t.update(changes)
    return t


def fields(b):
    return (b.n, b.offs, b.avg_qspan, b.max_dist_x, b.max_dist_y, b.bw,
            b.n_segs, b.x, b.y)


@pytest.mark.parametrize("name", ["ont", "sr"])
def test_a_seed_repeats_exactly(name):
    t = traffic(name)
    a, b = reads.batches(t, SEED, [1]), reads.batches(t, SEED, [0, 1])[1:]
    assert all(np.array_equal(u, v) for u, v in zip(fields(a[0]),
                                                    fields(b[0])))
    for other in (reads.batches(t, SEED + 1, [1])[0],
                  reads.batches(t, SEED, [2])[0]):
        assert not np.array_equal(a[0].x[:100], other.x[:100])


def test_hash64_is_minimap2s():
    mask = np.uint64((1 << 30) - 1)
    U = np.uint64

    def plain(key):             # sketch.c, in uint64
        key = (~key + (key << U(21))) & mask
        key = key ^ (key >> U(24))
        key = ((key + (key << U(3))) + (key << U(8))) & mask
        key = key ^ (key >> U(14))
        key = ((key + (key << U(2))) + (key << U(4))) & mask
        key = key ^ (key >> U(28))
        return (key + (key << U(31))) & mask

    key = np.random.default_rng(1).integers(0, 1 << 30, 4096).astype(U)
    got = reads.hash64(torch.from_numpy(key.view(np.int64)), 15)
    assert np.array_equal(got.numpy().view(U), plain(key))


@pytest.mark.parametrize("k,w", [(15, 10), (21, 11)])
def test_minimizers_are_the_plain_definition(k, w):
    """The smallest canonical hash of every w consecutive k-mers of one
    sequence (all of a tie), against a loop over the windows."""
    rng = np.random.default_rng(k)
    lens = [400, k + w - 2, 37, 300]
    b = rng.integers(0, 4, sum(lens))
    b[600:640] = b[560:600]            # a repeat: equal k-mers
    seg = torch.repeat_interleave(torch.arange(len(lens)),
                                  torch.tensor(lens))
    local = reads._seg_arange(torch.tensor(lens))
    pos, h, z = reads.minimizers(torch.from_numpy(b), seg, local, k, w)
    got = set(zip(pos.tolist(), h.tolist(), z.tolist()))
    want, start = set(), 0
    for n in lens:
        kmers = []
        for e in range(start + k - 1, start + n):
            s = b[e - k + 1:e + 1]
            f = int("".join(map(str, s)), 4)
            r = int("".join(str(3 - c) for c in s[::-1]), 4)
            hv = int(reads.hash64(torch.tensor([min(f, r)]), k)[0])
            kmers.append((e, hv, int(f > r)))
        for s in range(len(kmers) - w + 1):
            m = min(hv for _, hv, _ in kmers[s:s + w])
            want |= {km for km in kmers[s:s + w] if km[1] == m}
        start += n
    assert got == want and len(want) > 0


@pytest.mark.parametrize("name", ["ont", "sr"])
def test_a_batch_follows_its_traffic(name):
    t = traffic(name)
    b = reads.batches(t, SEED, [0])[0]
    K = t["k"]
    assert b.offs[-1] == len(b.x) == b.n.sum() and (b.n > 0).all()
    rec = np.repeat(np.arange(len(b)), b.n)
    span = ((b.y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    assert (span == K).all() and (b.avg_qspan == K).all()
    assert (b.bw == t["bw"]).all()
    sid = (b.y >> np.uint64(48)).astype(np.int64)
    q = (b.y & np.uint64(0xFFFFFFFF)).astype(np.int64)
    if t["pairs"]:
        qlen = 2 * t["read_length"]
        assert (b.n_segs == 2).all() and set(sid.tolist()) == {0, 1}
        assert (b.max_dist_x == max(t["max_frag_len"] - qlen,
                                    t["max_gap"])).all()
        assert (b.max_dist_y == qlen).all()
        # mate 2's query positions follow mate 1's; on the reverse
        # strand they are counted from the pair's end
        rev = (b.x >> np.uint64(63)).astype(bool)
        r = t["read_length"]
        assert (q[(sid == 1) & ~rev] >= r + K - 1).all()
        assert (q[(sid == 1) & rev] < r).all()
        assert (q[(sid == 0) & rev] >= r + K - 1).all()
    else:
        assert (b.n_segs == 1).all() and (sid == 0).all()
        assert (b.max_dist_x == t["max_gap"]).all()
        assert (b.max_dist_y >= t["max_gap"]).all()
        assert (q < b.max_dist_y[rec]).all() and (q >= K - 1).all()
    # sorted by x (unsigned) within each record; both strands occur
    first = np.zeros(len(b.x), bool)
    first[b.offs[:-1]] = True
    up = (b.x[1:] >= b.x[:-1]) | first[1:]
    assert up.all()
    rev = (b.x >> np.uint64(63)).astype(bool)
    assert 0.3 < rev.mean() < 0.7
    pos = (b.x & np.uint64(0xFFFFFFFF)).astype(np.int64)
    rid = ((b.x >> np.uint64(32)) & np.uint64(0x7FFFFFFF)).astype(np.int64)
    assert (rid < len(t["contigs"])).all()
    assert (pos < np.asarray(t["contigs"])[rid]).all()
    # the reads are drawn until batch_bases query bases
    per_read = (2 * t["read_length"] if t["pairs"] else t["length_mean"])
    assert len(b) > t["batch_bases"] / per_read / 3


def test_a_read_without_errors_gives_a_perfect_diagonal():
    """Reads with no errors: on each record's main strand and contig,
    reference and query steps between anchors agree."""
    t = traffic("ont", identity={"mean": 0.99, "max": 1.0, "sd": 1e-4},
                error_shares={"sub": 1})
    b = reads.batches(t, SEED, [0])[0]
    hits = 0
    for r in range(len(b)):
        x, y = b.x[b.offs[r]:b.offs[r + 1]], b.y[b.offs[r]:b.offs[r + 1]]
        word = x >> np.uint64(32)
        words, counts = np.unique(word, return_counts=True)
        main = word == words[np.argmax(counts)]
        xs = (x[main] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        qs = (y[main] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        diag = xs - qs
        hits += np.mean(diag == np.bincount(diag - diag.min()).argmax()
                        + diag.min()) > 0.9
    assert hits >= 0.9 * len(b)
