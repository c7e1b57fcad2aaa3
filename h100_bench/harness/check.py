"""How `correct` is decided: the program's answers against the plain
reference's.

Every record of every batch the window completed must have an answer of
its record's length (`missing_records` counts those that do not).  Of
each distinct input, a sample of records drawn from the seed
(`check_records` of the traffic file, the same records in every batch of
that input) is solved again by the reference, at the precision the
configuration states, and every batch's answers on the sample must equal
its answers exactly (`mismatched_records` counts the (batch, record)
pairs that differ).  The reference runs once the window has closed, one
worker process per input, and is handed the same records as the program.
"""

from __future__ import annotations

import multiprocessing
import os
import pathlib
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from h100_bench.harness import cores

LIMITS = {"mismatched_records": 0, "missing_records": 0}


def sample(seed: int, k: int, records: int, want: int) -> np.ndarray:
    """The records of input k that are checked, drawn from the seed."""
    rng = np.random.default_rng([seed % (1 << 64), k, 1 << 20])
    return np.sort(rng.choice(records, size=min(want, records),
                              replace=False))


def missing(result: Sequence, lengths: np.ndarray, n_out: int) -> int:
    """Records without an answer of their length in every output."""
    if len(result) != len(lengths):
        return len(lengths)
    bad = 0
    for r, n in zip(result, lengths.tolist()):
        if r is None or any(a is None or len(a) != n for a in r[:n_out]):
            bad += 1
    return bad


def pick(result: Sequence, idx: np.ndarray, n_out: int) -> list:
    """Copies of the answers of records `idx`, None where there is none,
    so that the rest of the batch's answers can be freed."""
    out = []
    for r in idx.tolist():
        res = result[r] if r < len(result) else None
        out.append(None if res is None else tuple(
            None if a is None else np.array(a) for a in res[:n_out]))
    return out


def _solve(ref_path: str, batch, config: dict, precision: str):
    from h100_bench.harness.cell import load_module
    counts: Dict[str, int] = {}
    answers = load_module(pathlib.Path(ref_path)).solve(
        batch, config, precision, counts=counts)
    return answers, counts


def solve_all(ref_path: pathlib.Path, batches: Dict[int, object],
              config: dict, precision: str,
              counts: Optional[Dict[str, int]] = None
              ) -> Dict[int, List[tuple]]:
    """The reference's answers for each batch, in worker processes (one
    per batch, as many at once as half the cores the process started
    with, which it gets back), all of which have ended when it returns.
    `counts`, when a dict, gets the reference's event counts summed."""
    keys = sorted(batches)
    cores.release()
    n_cores = len(os.sched_getaffinity(0))
    workers = max(1, min(len(keys), n_cores // 2))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = {k: ex.submit(_solve, str(ref_path), batches[k], config,
                             precision) for k in keys}
        done = {k: f.result() for k, f in futs.items()}
    if counts is not None:
        for _, c in done.values():
            for name, v in c.items():
                counts[name] = counts.get(name, 0) + v
    return {k: a for k, (a, _) in done.items()}


def mismatched(got: Sequence, want: Sequence, n_out: int) -> int:
    """Records whose answers differ from the reference's."""
    return sum(1 for g, w in zip(got, want)
               if g is None or not all(
                   a is not None and np.array_equal(np.asarray(a), b)
                   for a, b in zip(g[:n_out], w[:n_out])))
