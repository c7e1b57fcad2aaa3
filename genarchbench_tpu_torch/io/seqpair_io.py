"""Reader for the bpm/wfa sequence-pair dataset format.

Format (wfa/README.md:28-41): each pair is two lines
  >PATTERN
  <TEXT
The bpm benchmark program swaps so the *longer* raw line becomes the
pattern (bpm/tools/align_benchmark.c:175-180 compares getline lengths,
i.e. sequence lengths, since both lines carry one prefix char and a
newline).
The wfa benchmark program does NOT swap.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

# A=0 C=1 G=2 T=3, anything else 4 (reference: bpm/utils/dna_text.c:47-52)
_ENC = np.full(256, 4, np.uint8)
for i, c in enumerate("ACGT"):
    _ENC[ord(c)] = i
    _ENC[ord(c.lower())] = i


def encode_dna(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode(), np.uint8)]


@dataclasses.dataclass
class SeqPairs:
    patterns: List[np.ndarray]   # encoded uint8 arrays
    texts: List[np.ndarray]

    def __len__(self):
        return len(self.patterns)


def read_seqpairs(path: str, swap_longer_first: bool = False) -> SeqPairs:
    patterns, texts = [], []
    with open(path) as f:
        while True:
            l1 = f.readline()
            l2 = f.readline()
            if not l1 or not l2:
                break
            s1 = l1.rstrip("\n")[1:]
            s2 = l2.rstrip("\n")[1:]
            if swap_longer_first and len(s1) < len(s2):
                s1, s2 = s2, s1
            patterns.append(encode_dna(s1))
            texts.append(encode_dna(s2))
    return SeqPairs(patterns, texts)
