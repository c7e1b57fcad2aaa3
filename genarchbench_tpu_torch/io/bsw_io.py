"""Reader for the bsw 3-line pair format.

Format (bsw/src/main_banded.cpp:154-206 `loadPairs`):
  line 1: h0 seed score
  line 2: reference sequence, bases as ASCII '0'..'3' ('4' = ambiguous)
  line 3: query sequence, same encoding
Bases are decoded by subtracting 48; AMBIG (4) becomes 0xFFFF in the SoA
(bandedSWA.cpp:3621: `seq1[k]==AMBIG ? 0xFFFF : seq1[k]`).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

AMBIG = 4
AMBIG_SENTINEL = 0xFFFF


@dataclasses.dataclass
class BswPairs:
    h0: np.ndarray            # (n,) int32
    refs: List[np.ndarray]    # decoded int32 arrays (AMBIG -> 0xFFFF)
    quers: List[np.ndarray]

    def __len__(self):
        return len(self.refs)


def read_bsw_pairs(path: str) -> BswPairs:
    h0s, refs, quers = [], [], []
    with open(path) as f:
        while True:
            l1 = f.readline()
            if not l1.strip():
                break
            l2 = f.readline()
            l3 = f.readline()
            if not l2 or not l3:
                break
            h0s.append(int(l1))
            for line, dest in ((l2, refs), (l3, quers)):
                seq = np.frombuffer(line.rstrip("\n").encode(), np.uint8).astype(np.int32) - 48
                seq = np.where(seq == AMBIG, AMBIG_SENTINEL, seq)
                dest.append(seq.astype(np.int32))
    return BswPairs(np.array(h0s, np.int32), refs, quers)
