"""The least time one NVIDIA H100 SXM could take for a batch's work.

Peaks from NVIDIA's H100 SXM data sheet at the 700 W limit: 3.35 TB/s
of HBM3, and 1.67e13 int32 operations a second (132 SMs x 64 INT32
lanes x 1.98 GHz boost; the sheet's 67 TFLOP/s fp32 counts an FMA as
two operations on 128 lanes an SM).  A configuration states its
operations a window cell, counted from the reference's inner loop with
loads not counted, and its bytes an anchor: each input field read once
and each output written once.  The work comes from the input, not from
the program, so a later kernel or graph is held to the same work.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 1.67e13


def bound_s(cells: int, anchors: int, config: dict) -> float:
    """max(operations / peak operations, bytes / peak bandwidth)."""
    return max(cells * config["ops_per_cell"] / PEAK_INT32_OPS_PER_S,
               anchors * config["bytes_per_anchor"] / PEAK_BYTES_PER_S)
