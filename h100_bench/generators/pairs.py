"""Seeded sequence pairs as WFA's `generate_dataset` makes them for
GenArchBench's wfa benchmark: a pattern of uniform random bases and a
text that is the pattern after random edits.

For a traffic file's parameters (each named with its source in the
file), batch k of a seed holds `pairs` pairs, each made so:

1. the pattern: `length` uniform random bases (codes 0-3, A C G T);
2. the text: the pattern with each base, on its own draw, substituted
   by a uniform random base (which may be the same one), followed by an
   inserted uniform random base, or deleted, each with probability
   `error_rate` / 3, and otherwise kept; an empty text becomes "A".

That is the error model of the JAX package's bench inputs
(`tests/synth.py::mutate`), drawn in bulk with NumPy from the seed and
the batch's index, so that the same seed gives the same batches on any
host and device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import numpy as np


@dataclasses.dataclass
class PairBatch:
    """One batch of pairs as flat arrays: pair r's pattern is
    pat[p_offs[r]:p_offs[r + 1]] and its text txt[t_offs[r]:t_offs[r +
    1]], bases as codes 0-3.  `n` is each pair's answer length, one
    score."""
    n: np.ndarray            # (B,) int64, all ones
    p_offs: np.ndarray       # (B + 1,) int64
    t_offs: np.ndarray       # (B + 1,) int64
    pat: np.ndarray          # uint8
    txt: np.ndarray          # uint8

    def __len__(self) -> int:
        return len(self.n)

    def patterns(self) -> List[np.ndarray]:
        o = self.p_offs.tolist()
        return [self.pat[a:b] for a, b in zip(o[:-1], o[1:])]

    def texts(self) -> List[np.ndarray]:
        o = self.t_offs.tolist()
        return [self.txt[a:b] for a, b in zip(o[:-1], o[1:])]

    def subset(self, idx: np.ndarray) -> "PairBatch":
        """The pairs `idx`, in that order, as a batch of their own."""
        idx = np.asarray(idx, np.int64)
        p_offs, pat = _take(self.p_offs, self.pat, idx)
        t_offs, txt = _take(self.t_offs, self.txt, idx)
        return PairBatch(self.n[idx], p_offs, t_offs, pat, txt)


def _take(offs: np.ndarray, flat: np.ndarray, idx: np.ndarray):
    lens = (offs[1:] - offs[:-1])[idx]
    out = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(lens, out=out[1:])
    at = np.repeat(offs[idx] - out[:-1], lens) + np.arange(out[-1])
    return out, flat[at]


def _batch(t: dict, seed: int, k: int) -> PairBatch:
    rng = np.random.default_rng([seed % (1 << 64), k])
    B, L, err = int(t["pairs"]), int(t["length"]), float(t["error_rate"])
    pat = rng.integers(0, 4, (B, L), dtype=np.uint8)
    r = rng.random((B, L))
    first = np.where(r < err / 3, rng.integers(0, 4, (B, L), np.uint8), pat)
    second = rng.integers(0, 4, (B, L), np.uint8)
    # bases each pattern base leaves in the text: 1 (kept or
    # substituted), 2 (a base inserted after it) or 0 (deleted)
    emit = np.where(r < err / 3, 1, np.where(
        r < 2 * err / 3, 2, np.where(r < err, 0, 1)))
    keep = np.arange(2) < emit[:, :, None]
    txt = np.stack([first, second], axis=2)[keep]
    t_lens = emit.sum(1)
    empty = np.flatnonzero(t_lens == 0)
    if len(empty):      # "A" for an empty text, as the model has it
        at = np.cumsum(t_lens)[empty] - t_lens[empty]
        txt = np.insert(txt, at, 0)
        t_lens[empty] = 1
    t_offs = np.zeros(B + 1, np.int64)
    np.cumsum(t_lens, out=t_offs[1:])
    return PairBatch(np.ones(B, np.int64), np.arange(B + 1) * L, t_offs,
                     pat.reshape(-1), txt)


def batches(traffic: dict, seed: int, ks: Iterable[int],
            device="cpu") -> List[PairBatch]:
    """Batches `ks` of the traffic for `seed`, host arrays on any
    `device`: the program copies them to its card itself."""
    return [_batch(traffic, seed, int(k)) for k in ks]
