"""Bucketing of variable-length records.

`plan_batches` packs records into plans of one power-of-two padded
length each, under a cell budget.  The JAX package chose pow2 shapes
to bound the number of TPU compiles; here they bound the device memory
of a plan.  Outputs are per record, so the plan changes no result.
The port's own copy of the JAX package's sharding/batching.py, without
`pad_stack` (the port pads a plan's planes with one masked fill each)
and without the padded batch size, which no caller reads.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


def next_pow2(v: int, lo: int = 1) -> int:
    p = lo
    while p < v:
        p *= 2
    return p


MIN_LENGTH = 16


@dataclasses.dataclass
class BatchPlan:
    indices: List[int]     # original record indices in this batch
    length: int            # padded per-record length (pow2, >= MIN_LENGTH)


def plan_batches(lengths: Sequence[int], cell_budget: int,
                 max_batch: int) -> List[BatchPlan]:
    """Pack records into batches of a padded pow2 length.

    Sorts records by length (desc) so same-bucket records have similar
    padded length, then greedily fills batches of at most `max_batch`
    records under `cell_budget` (records * padded_length) to bound
    device memory: each plan is the next run of the sorted order.
    Returns plans whose `indices` cover every input exactly once.
    """
    lengths = np.asarray(lengths)
    order = np.argsort(lengths)[::-1]
    plans: List[BatchPlan] = []
    i = 0
    nrec = len(order)
    while i < nrec:
        plen = next_pow2(max(int(lengths[order[i]]), 1), MIN_LENGTH)
        j = min(nrec, i + max(1, min(max_batch, cell_budget // plen)))
        plans.append(BatchPlan(order[i:j].tolist(), plen))
        i = j
    return plans
