"""The `wfa` configuration on the program: a batch's pairs through the
entry its configuration names (`wfa_batch`, the function the wfa CLI's
region of interest calls), on one card, with the configuration's
penalties.

The program answers with one RLE CIGAR a pair.  The check reads a
pair's answer as the CIGAR's gap-affine score where the CIGAR is a
global alignment of that pair (M ops matches, X ops mismatches, I ops
text bases, D ops pattern bases, both sequences consumed exactly), -1
where it is not, and no answer for an empty CIGAR.  The CIGARs are
turned into answers only when the check reads them, after the window,
so that a timed batch holds the program alone; equal CIGARs of a pair
are scored once.
"""

from __future__ import annotations

import json
import pathlib
import re
from collections.abc import Sequence
from typing import Dict, List, Optional, Tuple

import numpy as np

CONFIG = pathlib.Path(__file__).resolve().parent.parent / "configs" / "wfa.json"
OP = re.compile(r"(\d+)([MXID])")


def cigar_score(cigar: str, p: bytes, t: bytes, x: int, o: int,
                e: int) -> int:
    """The gap-affine score of `cigar` as an alignment of pattern `p`
    with text `t` (a gap's run of one op, however the CIGAR splits it,
    opens once), or -1 where it is no global alignment of them."""
    i = j = score = end = 0
    prev = ""
    for m in OP.finditer(cigar):
        n, op = int(m.group(1)), m.group(2)
        if m.start() != end or n == 0:
            return -1
        end = m.end()
        di, dj = (0, n) if op == "I" else (n, 0) if op == "D" else (n, n)
        if i + di > len(p) or j + dj > len(t):
            return -1
        if op == "M" and p[i:i + n] != t[j:j + n]:
            return -1
        if op == "X":
            if any(a == b for a, b in zip(p[i:i + n], t[j:j + n])):
                return -1
            score += n * x
        elif op in "ID":
            score += n * e + (o if op != prev else 0)
        i, j, prev = i + di, j + dj, op
    if end != len(cigar) or i != len(p) or j != len(t):
        return -1
    return score


class Inputs:
    """A batch's pairs as the program takes them, the penalties, and each
    pair's bases as bytes for the scoring."""

    def __init__(self, batch, config: dict):
        from genarchbench_tpu_torch.io.seqpair_io import SeqPairs
        self.pairs = SeqPairs(batch.patterns(), batch.texts())
        self.penalties = (config["x"], config["o"], config["e"])
        self.bases = [(p.tobytes(), t.tobytes())
                      for p, t in zip(self.pairs.patterns, self.pairs.texts)]
        self.scored: Dict[Tuple[int, str], tuple] = {}


class Answers(Sequence):
    """Pair r's answer, (np.array([score]),), or None for an empty
    CIGAR, made from its CIGAR when read."""

    def __init__(self, cigars: List[str], inputs: Inputs):
        self.cigars = cigars
        self.inputs = inputs

    def __len__(self) -> int:
        return len(self.cigars)

    def __getitem__(self, r: int) -> Optional[tuple]:
        cigar = self.cigars[r]
        if not cigar:
            return None
        memo = self.inputs.scored
        if (r, cigar) not in memo:
            memo[(r, cigar)] = (np.array([cigar_score(
                cigar, *self.inputs.bases[r], *self.inputs.penalties)]),)
        return memo[(r, cigar)]


def inputs(batch) -> Inputs:
    return Inputs(batch, json.loads(CONFIG.read_text()))


def run(entry, inputs: Inputs, device, stats=None) -> Answers:
    """entry(pairs) on `device` with the configuration's penalties: the
    CIGARs as the program returns them, read as answers later."""
    x, o, e = inputs.penalties
    return Answers(entry(inputs.pairs, x=x, o=o, e=e, device=device,
                         stats=stats), inputs)
