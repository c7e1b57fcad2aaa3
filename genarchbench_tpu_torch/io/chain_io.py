"""Text I/O for the chain / fast-chain anchor-record format.

Format contract (reference: chain/src/host_data_io.cpp:13-60):
  input record:  "n avg_qspan max_dist_x max_dist_y bw n_segs" header,
                 then n lines "x y" (uint64 pairs), then a literal "EOR".
  output record: "n\\n", then n lines "score<TAB>parent", then "EOR\\n".

Each record keeps its anchors as the two uint64 planes of the file; the
views split x into (hi, lo) uint32 halves and decode y into qi / q_span /
sid (the reference decodes these on the fly: chain/src/host_kernel.cpp:
52-55).  The port's own copy of the JAX package's io/chain_io.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, TextIO

import numpy as np


@dataclasses.dataclass
class ChainRecord:
    n: int
    avg_qspan: float
    max_dist_x: int
    max_dist_y: int
    bw: int
    n_segs: int
    x: np.ndarray          # (n,) uint64 anchor positions (sorted)
    y: np.ndarray          # (n,) uint64 packed query pos / span / seg-id

    @property
    def x_lo(self) -> np.ndarray:
        return (self.x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    @property
    def x_hi(self) -> np.ndarray:
        return (self.x >> np.uint64(32)).astype(np.uint32)

    @property
    def qi(self) -> np.ndarray:
        return (self.y & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)

    @property
    def q_span(self) -> np.ndarray:
        return ((self.y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)

    @property
    def sid(self) -> np.ndarray:
        return ((self.y >> np.uint64(48)) & np.uint64(0xFF)).astype(np.int32)

    def window_starts(self, max_iter: int = 5000) -> np.ndarray:
        """Per-anchor window start `st` (reference chain/src/host_kernel.cpp:56-57).

        The reference advances a persistent two-pointer `st` while
        `x[i] > x[st] + max_dist_x`, then clamps to `i - max_iter`; with x
        sorted this equals the running maximum of
        max(searchsorted(x, x[i]-max_dist_x), i-max_iter).  The plain
        version of `window_starts_all`.
        """
        n = self.n
        if n == 0:
            return np.zeros(0, np.int32)
        mdx = np.uint64(self.max_dist_x)
        thresh = np.where(self.x >= mdx, self.x - mdx, np.uint64(0))
        st_raw = np.searchsorted(self.x, thresh, side="left")
        st = np.maximum(st_raw, np.arange(n, dtype=np.int64) - max_iter)
        st = np.maximum.accumulate(st)
        return np.minimum(st, np.arange(n, dtype=np.int64)).astype(np.int32)


def window_starts_all(records: Sequence[ChainRecord],
                      max_iter: int = 5000) -> List[np.ndarray]:
    """Per-record window starts from one O(total anchors) two-pointer
    sweep in C (native/chain.c::chain_window_starts)."""
    from genarchbench_tpu_torch import native
    offs = np.zeros(len(records) + 1, np.int64)
    np.cumsum([r.n for r in records], out=offs[1:])
    flat = native.chain_window_starts(
        offs, np.concatenate([r.x for r in records] + [np.zeros(0, np.uint64)]),
        np.array([r.max_dist_x for r in records], np.int64), max_iter)
    return [flat[offs[k]:offs[k + 1]] for k in range(len(records))]


def read_records_path(path: str) -> List[ChainRecord]:
    """Read a chain file by path."""
    with open(path) as f:
        return list(read_records(f))


def read_records(fp: TextIO) -> Iterator[ChainRecord]:
    """Stream records from a chain-format text file."""
    text = fp.read()
    pos = 0
    ln = len(text)
    while True:
        eor = text.find("EOR", pos)
        toks = text[pos:eor if eor >= 0 else ln].split()
        if len(toks) < 6:
            return
        n = int(toks[0])
        avg_qspan = float(toks[1])
        mdx, mdy, bw, n_segs = (int(t) for t in toks[2:6])
        vals = np.array(toks[6:6 + 2 * n], dtype=np.uint64)
        if vals.size < 2 * n:
            return
        anchors = vals.reshape(n, 2)
        yield ChainRecord(n, avg_qspan, mdx, mdy, bw, n_segs,
                          np.ascontiguousarray(anchors[:, 0]),
                          np.ascontiguousarray(anchors[:, 1]))
        if eor < 0:
            return
        pos = eor + 3


def write_returns(fp: TextIO, results: Sequence) -> None:
    """results: iterable of (scores, parents) int arrays per record."""
    out: List[str] = []
    for scores, parents in results:
        out.append(f"{len(scores)}\n")
        sp = np.stack([np.asarray(scores, np.int64),
                       np.asarray(parents, np.int64)], axis=1)
        out.extend(f"{a}\t{b}\n" for a, b in sp)
        out.append("EOR\n")
    fp.write("".join(out))
