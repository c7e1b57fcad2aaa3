"""What the chain-format references share: the window-start rule, the
linear gap cost at a stated precision, floor(log2), and the lock-step
layout that runs anchor i of every record at once.

Plain NumPy, written from the reference loops of GenArchBench
(`benchmarks/chain/src/host_kernel.cpp:30-94`, minimap2's `chain_dp`;
`benchmarks/fast-chain/src/host_kernel.cpp:803-866`, mm2-fast's scalar
loop).  It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np

I32_MIN = np.iinfo(np.int32).min


def window_starts(x: np.ndarray, offs: np.ndarray, max_dist_x: np.ndarray,
                  max_iter: int) -> np.ndarray:
    """Per anchor, the first predecessor its scan reaches, as an index
    within its record (host_kernel.cpp:56-57): st advances while
    x[i] > x[st] + max_dist_x, and i - st is at most max_iter.  With x
    sorted that is the first j with x[j] >= x[i] - max_dist_x.

    The thresholds x[i] - max_dist_x are merged into the anchors, record
    by record in x order, each before the anchors of equal x; as they are
    sorted within a record too, the anchors before threshold i are its
    merged place less the i thresholds before it."""
    n = np.diff(offs)
    a = len(x)
    rec = np.repeat(np.arange(len(n), dtype=np.int64), n)
    local = np.arange(a, dtype=np.int64) - offs[rec]
    m = np.repeat(max_dist_x.astype(np.uint64), n)
    thr = np.where(x >= m, x - m, np.uint64(0))
    order = np.lexsort((np.repeat(np.array([0, 1], np.int8), a),
                        np.concatenate([thr, x]), np.concatenate([rec, rec])))
    place = np.empty(2 * a, np.int64)
    place[order] = np.arange(2 * a, dtype=np.int64)
    st = place[:a] - np.arange(a, dtype=np.int64) - offs[rec]
    return np.minimum(np.maximum(st, local - max_iter), local)


def window_cells(x, offs, max_dist_x, max_iter) -> int:
    """(i, j) pairs the reference's inner loop visits: the sum of
    i - st(i) over every anchor."""
    st = window_starts(x, offs, max_dist_x, max_iter)
    n = np.diff(offs)
    local = np.arange(len(x), dtype=np.int64) - np.repeat(offs[:-1], n)
    return int((local - st).sum())


def work(batch, config: dict) -> dict:
    """A batch's work as the reference counts it: its records, anchors
    and window cells."""
    return {"records": len(batch.n), "anchors": len(batch.x),
            "cells": window_cells(batch.x, batch.offs, batch.max_dist_x,
                                  config["max_chain_iter"])}


def _bf16(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def linear_gap(dd: np.ndarray, avg32: np.ndarray, precision: str
               ) -> np.ndarray:
    """(int)(dd * .01 * avg_qspan), truncated toward zero, with each
    product rounded to `precision`: "f64" is minimap2's (double
    promotion, host_kernel.cpp:74), "f32" mm2-fast's (float math,
    fast-chain host_kernel.cpp:843), "bf16" the step below f32."""
    if precision == "f64":
        v = dd.astype(np.float64) * 0.01 * avg32.astype(np.float64)
    elif precision == "f32":
        v = (dd.astype(np.float32) * np.float32(0.01)) * avg32
    elif precision == "bf16":
        v = _bf16(_bf16(_bf16(dd.astype(np.float32)) * _bf16(
            np.float32(0.01))) * _bf16(avg32))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return v.astype(np.int32)


def ilog2(dd: np.ndarray) -> np.ndarray:
    """31 - clz((uint32)dd) for dd != 0, else 0, for int32 dd (the
    exponent of dd as a float64, which holds every int32 exactly)."""
    return np.maximum(np.frexp(dd.astype(np.float64))[1] - 1, 0)


class Planes:
    """A batch's anchors in the lock-step layout: records longest first,
    one row each, and every field a (B, L + N) plane of L columns of
    padding (L the widest window) and then the record's anchors, so that
    the window of anchor i of the first A records is the slice
    [:A, L+i-D : L+i].  Fields: x's low word (uint32), qi (int32, y's low
    word), q_span (y bits 32-39), sid (bits 48-55) and each anchor's
    window length i - st(i)."""

    def __init__(self, batch, max_iter: int):
        n = batch.n
        self.order = np.argsort(-n, kind="stable")
        self.ns = n[self.order]
        rank = np.empty(len(n), np.int64)
        rank[self.order] = np.arange(len(n))
        local = (np.arange(len(batch.x), dtype=np.int64)
                 - np.repeat(batch.offs[:-1], n))
        wlen = local - window_starts(batch.x, batch.offs, batch.max_dist_x,
                                     max_iter)
        self.L = int(wlen.max(initial=0))
        self.shape = (len(n), self.L + int(n.max(initial=0)))
        self._at = (np.repeat(rank, n), self.L + local)
        self.offs = batch.offs
        self.xl = self.plane(batch.x & np.uint64(0xFFFFFFFF), np.uint32)
        self.qi = self.plane(batch.y & np.uint64(0xFFFFFFFF), np.uint32) \
            .view(np.int32)
        self.span = self.plane((batch.y >> np.uint64(32)) & np.uint64(0xFF),
                               np.int32)
        self.sid = self.plane((batch.y >> np.uint64(48)) & np.uint64(0xFF),
                              np.int32)
        self.wlen = self.plane(wlen, np.int32)

    def plane(self, flat=None, dtype=np.int32) -> np.ndarray:
        """A zero plane, holding the flat per-anchor values `flat`."""
        p = np.zeros(self.shape, dtype)
        if flat is not None:
            p[self._at] = flat.astype(dtype)
        return p

    def rows(self, per_record: np.ndarray) -> np.ndarray:
        """A per-record array in row order, as a (B, 1) column."""
        return per_record[self.order][:, None]

    def steps(self):
        """(i, A, D) for anchor i = 0, 1, ...: the A records that have an
        anchor i, and the widest of their windows."""
        for i in range(self.shape[1] - self.L):
            a = int(np.searchsorted(-self.ns, -i, side="left"))
            yield i, a, int(self.wlen[:a, self.L + i].max(initial=0))

    def window(self, p: np.ndarray, i: int, a: int, d: int) -> np.ndarray:
        """(A, D) view of plane p over anchor i's predecessors in the
        scan's order: slot k is j = i - 1 - k."""
        return p[:a, self.L + i - d:self.L + i][:, ::-1]

    def split(self, p: np.ndarray):
        """Plane p as one array per record, in the batch's order."""
        flat = p[self._at]
        return [flat[o:e] for o, e in zip(self.offs[:-1], self.offs[1:])]
