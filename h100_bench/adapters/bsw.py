"""The `bsw` configuration on the program: a batch's extension pairs
through the entry its configuration names (`bsw_batch`, the function the
bsw CLI's region of interest calls), on one card, with the
configuration's scoring, band and sort slice.

The pairs are built as the program's `BswPairs` before the window:
bases as int32 codes, an N (4) as the reader's 0xFFFF.  A record is a
sort slice (`generators/extensions.py`): its answer is (the scores of
its pairs,).
"""

from __future__ import annotations

import json
import pathlib
from collections.abc import Sequence

import numpy as np

CONFIG = pathlib.Path(__file__).resolve().parent.parent / "configs" / "bsw.json"
SCORING = ("match", "mismatch", "ambig", "o_del", "e_del", "o_ins", "e_ins",
           "zdrop", "w", "end_bonus", "batch_size", "lanes")


class Inputs:
    """A batch's pairs as the program takes them, the keywords of the
    call, and each slice's pair offsets."""

    def __init__(self, batch, config: dict):
        from genarchbench_tpu_torch.io.bsw_io import AMBIG_SENTINEL, BswPairs

        def seqs(flat, offs):
            codes = np.where(flat == 4, AMBIG_SENTINEL, flat).astype(np.int32)
            o = offs.tolist()
            return [codes[a:b] for a, b in zip(o[:-1], o[1:])]

        self.pairs = BswPairs(batch.h0.astype(np.int32),
                              seqs(batch.ref, batch.r_offs),
                              seqs(batch.qry, batch.q_offs))
        self.kwargs = {k: config[k] for k in SCORING}
        self.slices = batch.slice_offsets().tolist()


class Answers(Sequence):
    """Slice r's answer, (the scores of its pairs,)."""

    def __init__(self, scores: np.ndarray, slices: list):
        self.scores = scores
        self.slices = slices

    def __len__(self) -> int:
        return len(self.slices) - 1

    def __getitem__(self, r: int) -> tuple:
        if not 0 <= r < len(self):
            raise IndexError(r)
        return (self.scores[self.slices[r]:self.slices[r + 1]],)


def inputs(batch) -> Inputs:
    return Inputs(batch, json.loads(CONFIG.read_text()))


def run(entry, inputs: Inputs, device, stats=None) -> Answers:
    """entry(pairs) on `device` alone; the entry takes no `stats=`."""
    return Answers(entry(inputs.pairs, device=device, **inputs.kwargs),
                   inputs.slices)
