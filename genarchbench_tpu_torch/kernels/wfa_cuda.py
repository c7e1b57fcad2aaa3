"""Gap-affine WFA on the card: the wrappers of the two CUDA kernels of
csrc/wfa.cu.  Their plain versions are the torch-op loops of
kernels/wfa.py (`_wfa_forward`, `_wfa_backtrace`), which CPU tensors
run.

The score loop (`wfa_forward`): one warp a pair runs the pair's loop
extend -> reduce -> end check -> compute s+1 to its own final score or
the score cap, and writes the backtrace store.  The pair's wavefront
rings and bounds (its workspace) and its bases live in shared memory
where two pairs' fit on one SM, else the workspaces go to a device
scratch; the choice follows the workspace's size, which the shapes and
penalties give.

The backtrace (`wfa_backtrace`): one thread a pair walks its own store
from its final score and writes the records the CIGAR assembly reads.

Layout:
  pat (B, Lp), txt (B, Lt) uint8  codes, padded; Lp and Lt multiples of 8
  plen, tlen (B,) int32
-> store (B, Scap, D) int32  code | run << 8 at the diagonals [lo, hi] of
                             every score up to a pair's final score
   fscore, foff (B,) int32, and a summary (4,) int64: unfinished pairs,
   max final score, the sum and the max of the score steps the pairs ran.
-> nmats (B, T) int32, ops (B, T) int8  a pair's match run and op of each
                             step, zeros after its walk's last step
   lanes (5, B) int32: gap_t, gap_v, fm, fd, fi, and a summary (1,)
   int32: the most steps a pair's walk took.
"""

from __future__ import annotations

import ctypes

import torch

from genarchbench_tpu_torch.kernels import _build

# launches of the score-loop and backtrace kernels in this process (a
# run shows with them that the main path went through the kernels)
LAUNCHES = 0
BT_LAUNCHES = 0


def _lib():
    lib = _build.library()
    for fn, ptrs, ints in ((lib.genarch_wfa_forward, 9, 12),
                           (lib.genarch_wfa_backtrace, 9, 8)):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def ring_slots(x: int, o: int, e: int):
    """(M ring slots, I and D ring slots) of a pair's workspace: the
    torch version's RS = max(x, o+e) + 1 and one more, so that a source
    read from the slot wavefront s+1 overwrites there (x, e or o + e
    equal to 0) is still intact; I and D read back e only."""
    rm = max(x, o + e) + 2
    return rm, (rm if e == 0 else e + 1)


def workspace_words(D: int, x: int, o: int, e: int) -> int:
    """int32 words of a pair's workspace: the rows of its rings and a
    (lo, hi, exists) triple a row."""
    rm, ri = ring_slots(x, o, e)
    return (rm + 2 * ri) * (D + 3)


def shared_bytes(Lp: int, Lt: int, D: int, x: int, o: int, e: int) -> int:
    """Shared memory of a pair kept on chip: its workspace, then its
    bases from a 16-byte boundary."""
    return (4 * workspace_words(D, x, o, e) + 15) // 16 * 16 + Lp + Lt


def in_shared(Lp: int, Lt: int, D: int, x: int, o: int, e: int,
              optin: int) -> bool:
    """Whether a pair's workspace and bases stay in shared memory: where
    at least two pairs fit on one SM (`optin`, the bytes a block may
    take)."""
    return shared_bytes(Lp, Lt, D, x, o, e) <= optin // 2


def _check(pat, txt, plen, tlen):
    B = pat.shape[0]
    for name, t, dt, dim in (("pat", pat, torch.uint8, 2),
                             ("txt", txt, torch.uint8, 2),
                             ("plen", plen, torch.int32, 1),
                             ("tlen", tlen, torch.int32, 1)):
        if t.dtype != dt or t.dim() != dim or t.shape[0] != B:
            raise ValueError(f"{name} must be {dt} with {dim} dims and {B} "
                             f"rows, got {t.dtype} {tuple(t.shape)}")
        if t.device != pat.device:
            raise ValueError(f"{name} is on {t.device}, pat on {pat.device}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{name} must be contiguous and 8-byte aligned")
    for name, t in (("pat", pat), ("txt", txt)):
        if t.shape[1] % 8:
            raise ValueError(f"{name}'s width must be a multiple of 8, got "
                             f"{t.shape[1]}")


def wfa_forward(pat, txt, plen, tlen, K0: int, D: int, Scap: int, x: int,
                o: int, e: int, red_len: int = 0, red_dist: int = 0):
    """One pass of the score loop over a chunk of CUDA tensors at the
    store geometry (K0, D) and cap Scap: (store, fscore, foff, summary),
    enqueued on the current stream."""
    global LAUNCHES
    if pat.device.type != "cuda":
        raise ValueError(f"wfa_forward runs on cuda, not {pat.device}")
    _check(pat, txt, plen, tlen)
    B, Lp = pat.shape
    Lt = txt.shape[1]
    dev = pat.device
    store = torch.empty((B, Scap, D), dtype=torch.int32, device=dev)
    fscore, foff = (torch.empty(B, dtype=torch.int32, device=dev)
                    for _ in range(2))
    summary = torch.zeros(4, dtype=torch.int64, device=dev)
    if B == 0:
        return store, fscore, foff, summary
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if in_shared(Lp, Lt, D, x, o, e, optin):
        smem, gws = shared_bytes(Lp, Lt, D, x, o, e), None
    else:
        smem = 0
        gws = torch.empty(B * workspace_words(D, x, o, e), dtype=torch.int32,
                          device=dev)
    lib = _lib()
    # the library launches on the current card: make it the tensors'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.genarch_wfa_forward(
            pat.data_ptr(), txt.data_ptr(), plen.data_ptr(), tlen.data_ptr(),
            store.data_ptr(), fscore.data_ptr(), foff.data_ptr(),
            summary.data_ptr(),
            gws.data_ptr() if gws is not None else None, B, Lp, Lt, K0, D,
            Scap, x, o, e, red_len, red_dist, smem, stream)
    LAUNCHES += 1
    _build.check(err, "wfa kernel")
    return store, fscore, foff, summary


def _check_backtrace(store, fscore, foff, plen, tlen, K0: int, T: int):
    if store.dtype != torch.int32 or store.dim() != 3 \
            or not store.is_contiguous():
        raise ValueError(f"store must be a contiguous (B, Scap, D) "
                         f"torch.int32, got {store.dtype} "
                         f"{tuple(store.shape)}")
    B, _, D = store.shape
    for name, t in (("fscore", fscore), ("foff", foff), ("plen", plen),
                    ("tlen", tlen)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B},) "
                             f"torch.int32, got {t.dtype} {tuple(t.shape)}")
        if t.device != store.device:
            raise ValueError(f"{name} is on {t.device}, store on "
                             f"{store.device}")
    if not 0 <= K0 < D or T < 0:
        raise ValueError(f"K0 {K0} must lie in [0, {D}) and T {T} >= 0")


def wfa_backtrace(store, fscore, foff, plen, tlen, K0: int, x: int, o: int,
                  e: int, T: int):
    """The backtrace of a chunk of CUDA tensors over the store the score
    loop wrote at diagonal origin K0, at most T steps a pair: (nmats,
    ops, lanes, summary), enqueued on the current stream."""
    global BT_LAUNCHES
    if store.device.type != "cuda":
        raise ValueError(f"wfa_backtrace runs on cuda, not {store.device}")
    _check_backtrace(store, fscore, foff, plen, tlen, K0, T)
    B, Scap, D = store.shape
    dev = store.device
    nmats = torch.empty((B, T), dtype=torch.int32, device=dev)
    ops = torch.empty((B, T), dtype=torch.int8, device=dev)
    lanes = torch.empty((5, B), dtype=torch.int32, device=dev)
    summary = torch.empty(1, dtype=torch.int32, device=dev)
    if B == 0:
        summary.zero_()
        return nmats, ops, lanes, summary
    lib = _lib()
    # the library launches on the current card: make it the tensors'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.genarch_wfa_backtrace(
            store.data_ptr(), fscore.data_ptr(), foff.data_ptr(),
            plen.data_ptr(), tlen.data_ptr(), nmats.data_ptr(),
            ops.data_ptr(), lanes.data_ptr(), summary.data_ptr(), B, Scap,
            D, K0, x, o, e, T, stream)
    BT_LAUNCHES += 1
    _build.check(err, "wfa backtrace kernel")
    return nmats, ops, lanes, summary
