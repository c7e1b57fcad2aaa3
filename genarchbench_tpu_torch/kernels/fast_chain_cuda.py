"""fast-chain's anchor loop on the card: the wrapper of the CUDA kernel of
csrc/fast_chain.cu.  Its plain version is the torch-op loop of
kernels/fast_chain.py (`_fast_chain_device`), which CPU tensors run.

One warp a record walks the record's anchors in order, scoring each
anchor's window of predecessors over its lanes, so one launch runs a
whole plan.  A record's x, q and scores so far live in shared memory
where a block's WARPS records fit in 48 KB, else the kernel reads the
predecessors from the input rows and their scores from the output row;
the choice follows the plan's padded length N.

Layout:
  x_lo, qi, q_span, st (B, N) int32  a row's anchors first: x's low word
                                     (uint32 bits), qi, q_span, window
                                     start (st = i, span 0 past n)
  mdxy, bw (B,) int32, avg (B,) float32
-> scores, parents (B, N) int32      the first `steps` anchors of each row
                                     scored, 0 and -1 after them
"""

from __future__ import annotations

import ctypes

import torch

from genarchbench_tpu_torch.kernels import _build

# launches of the kernel in this process (a run shows with it that the
# main path went through the kernel)
LAUNCHES = 0

WARPS = 4                   # records a block (csrc/fast_chain.cu kWarps)
SHARED_BYTES = 48 * 1024    # a block's shared memory without an opt-in


def _lib():
    lib = _build.library()
    fn = lib.genarch_fast_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def store_bytes(N: int) -> int:
    """Shared memory of a block whose records' stores stay on chip: x,
    q and a score for each of a record's N anchors."""
    return WARPS * 3 * 4 * N


def in_shared(N: int) -> bool:
    """Whether a plan of padded length N keeps its records' stores in
    shared memory."""
    return store_bytes(N) <= SHARED_BYTES


def _check(x_lo, qi, q_span, st, mdxy, bw, avg, steps: int):
    if x_lo.dim() != 2:
        raise ValueError(f"x_lo must be (B, N), got {tuple(x_lo.shape)}")
    B, N = x_lo.shape
    for name, t, dt, shape in (("x_lo", x_lo, torch.int32, (B, N)),
                               ("qi", qi, torch.int32, (B, N)),
                               ("q_span", q_span, torch.int32, (B, N)),
                               ("st", st, torch.int32, (B, N)),
                               ("mdxy", mdxy, torch.int32, (B,)),
                               ("bw", bw, torch.int32, (B,)),
                               ("avg", avg, torch.float32, (B,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x_lo.device:
            raise ValueError(f"{name} is on {t.device}, x_lo on "
                             f"{x_lo.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 <= steps <= N:
        raise ValueError(f"steps {steps} must lie in [0, {N}]")


def fast_chain(x_lo, qi, q_span, st, mdxy, bw, avg, steps: int):
    """The DP of one plan of CUDA tensors over the first `steps` anchors
    of each row: (scores, parents), enqueued on the current stream."""
    global LAUNCHES
    if x_lo.device.type != "cuda":
        raise ValueError(f"fast_chain runs on cuda, not {x_lo.device}")
    _check(x_lo, qi, q_span, st, mdxy, bw, avg, steps)
    B, N = x_lo.shape
    scores, parents = (torch.empty((B, N), dtype=torch.int32,
                                   device=x_lo.device) for _ in range(2))
    if B == 0:
        return scores, parents
    lib = _lib()
    # the library launches on the current card: make it the tensors'
    with torch.cuda.device(x_lo.device):
        stream = torch.cuda.current_stream(x_lo.device).cuda_stream
        err = lib.genarch_fast_chain(
            x_lo.data_ptr(), qi.data_ptr(), q_span.data_ptr(), st.data_ptr(),
            mdxy.data_ptr(), bw.data_ptr(), avg.data_ptr(),
            scores.data_ptr(), parents.data_ptr(), B, N, steps,
            store_bytes(N) if in_shared(N) else 0, stream)
    LAUNCHES += 1
    _build.check(err, "fast-chain kernel")
    return scores, parents
