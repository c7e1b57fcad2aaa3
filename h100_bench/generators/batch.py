"""A batch of chain-format records as flat arrays, as generators make it
and the references and adapters read it."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AnchorBatch:
    """One batch of records as flat arrays: record r holds anchors
    offs[r]:offs[r + 1] of x and y, sorted by x, with minimap2's layout

      x = rev << 63 | rid << 32 | reference position
      y = sid << 48 | q_span << 32 | query position
    """
    n: np.ndarray            # (B,) int64
    offs: np.ndarray         # (B + 1,) int64
    avg_qspan: np.ndarray    # (B,) float32
    max_dist_x: np.ndarray   # (B,) int64
    max_dist_y: np.ndarray
    bw: np.ndarray
    n_segs: np.ndarray
    x: np.ndarray            # (A,) uint64
    y: np.ndarray            # (A,) uint64

    def __len__(self) -> int:
        return len(self.n)

    def subset(self, idx: np.ndarray) -> "AnchorBatch":
        """The records `idx`, in that order, as a batch of their own."""
        idx = np.asarray(idx, np.int64)
        n = self.n[idx]
        offs = np.zeros(len(idx) + 1, np.int64)
        np.cumsum(n, out=offs[1:])
        flat = (np.repeat(self.offs[idx] - offs[:-1], n)
                + np.arange(offs[-1], dtype=np.int64))
        return AnchorBatch(n, offs, self.avg_qspan[idx],
                           self.max_dist_x[idx], self.max_dist_y[idx],
                           self.bw[idx], self.n_segs[idx], self.x[flat],
                           self.y[flat])
