"""Myers bit-vector edit distance: the wrapper of the CUDA kernel
(csrc/bpm.cu) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas kernel
(genarchbench_tpu/kernels/bpm_pallas.py::_kernel); the plain version is
a port of its XLA formulation (kernels/bpm.py::_bpm_distance_device).
For W <= 32 the kernel is a wavefront: a pair takes a segment of
`segment_width(W)` lanes of a warp, one pattern word a lane, and lane w
advances text step k - w at iteration k.  Wider patterns take a generic
kernel, one thread per pair.

Layout, pairs-minor so that a warp's loads coalesce:
  peq  (W, 4, B) int32  the uint32 match masks of compile_peq, as bits
  plen (B,) int32       pattern lengths
  text (T, B) int8      text codes 0-3 (4 = N matches nothing)
  tlen (B,) int32       text lengths; steps t >= tlen (or >= T) are not taken
-> (B,) int32 edit distances.
"""

from __future__ import annotations

import ctypes

import torch

from genarchbench_tpu_torch.kernels import _build

W32 = 32
_M32 = 0xFFFFFFFF

# launches of the CUDA kernel in this process (a run shows with it that
# the main path went through the kernel)
LAUNCHES = 0


def _lib():
    lib = _build.library()
    fn = lib.genarch_bpm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def segment_width(W: int) -> int:
    """Lanes a pair takes in the wavefront kernel: the power of two at or
    above W; 0 outside 1..32 (the generic kernel)."""
    if not 1 <= W <= W32:
        return 0
    return 1 << (W - 1).bit_length()


def _check(peq, plen, text, tlen):
    if peq.dim() != 3 or peq.shape[1] != 4:
        raise ValueError(f"peq must be (W, 4, B), got {tuple(peq.shape)}")
    W, _, B = peq.shape
    if text.dim() != 2 or text.shape[1] != B:
        raise ValueError(f"text must be (T, {B}), got {tuple(text.shape)}")
    for name, x, dt, shape in (("peq", peq, torch.int32, None),
                               ("plen", plen, torch.int32, (B,)),
                               ("text", text, torch.int8, None),
                               ("tlen", tlen, torch.int32, (B,))):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != peq.device:
            raise ValueError(f"{name} is on {x.device}, peq on {peq.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bpm_distance(peq: torch.Tensor, plen: torch.Tensor, text: torch.Tensor,
                 tlen: torch.Tensor) -> torch.Tensor:
    """Edit distances; launches the CUDA kernel for CUDA tensors and runs
    `bpm_distance_plain` for CPU tensors."""
    global LAUNCHES
    _check(peq, plen, text, tlen)
    if peq.device.type == "cpu":
        return bpm_distance_plain(peq, plen, text, tlen)
    if peq.device.type != "cuda":
        raise ValueError(f"bpm_distance runs on cuda or cpu, not {peq.device}")
    W, _, B = peq.shape
    T = text.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=peq.device)
    if B == 0:
        return out
    # the wavefront kernel's text packed as 4-step nibble words, or the
    # generic kernel's Pv/Mv (W > 32)
    S = segment_width(W)
    scratch = (torch.empty(((T + 3) // 4, B), dtype=torch.int16,
                           device=peq.device) if S else
               torch.empty((2, W, B), dtype=torch.int32, device=peq.device))
    lib = _lib()
    # the library launches on the current card: make it the tensors'
    with torch.cuda.device(peq.device):
        stream = torch.cuda.current_stream(peq.device).cuda_stream
        err = lib.genarch_bpm(peq.data_ptr(), text.data_ptr(),
                              plen.data_ptr(), tlen.data_ptr(),
                              out.data_ptr(), scratch.data_ptr(), B, T, W,
                              S, stream)
    LAUNCHES += 1
    _build.check(err, "bpm kernel")
    return out


def bpm_distance_plain(peq: torch.Tensor, plen: torch.Tensor,
                       text: torch.Tensor, tlen: torch.Tensor) -> torch.Tensor:
    """The same distances with torch ops (bpm.py:64-114).  The uint32
    words are held in int64 and masked to 32 bits after `+`, `<<` and
    `~`, which torch does not offer on uint32."""
    W, _, B = peq.shape
    T = text.shape[0]
    dev = peq.device
    i64 = torch.int64
    # Eq table with a fifth, all-zero column for codes outside 0..3
    eqtab = torch.cat([peq.to(i64) & _M32,
                       torch.zeros((W, 1, B), dtype=i64, device=dev)], dim=1)
    codes = text.to(i64)
    codes = torch.where((codes >= 0) & (codes < 4), codes, 4)
    pv = [torch.full((B,), _M32, dtype=i64, device=dev)] * W
    mv = [torch.zeros(B, dtype=i64, device=dev)] * W
    top = torch.ones(B, dtype=i64, device=dev) << ((plen.to(i64) - 1) % W32)
    msb = 1 << 31
    tlen = tlen.to(i64)
    score = plen.to(i64)
    ones = torch.ones(B, dtype=i64, device=dev)
    zeros = torch.zeros(B, dtype=i64, device=dev)
    for t in range(T):
        eq = eqtab.gather(1, codes[t].view(1, 1, B).expand(W, 1, B))[:, 0]
        ph_in, mh_in = ones, zeros
        for w in range(W):
            e, p, m = eq[w], pv[w], mv[w]
            xv = e | m
            e_ = e | mh_in
            xh = ((((e_ & p) + p) & _M32) ^ p) | e_
            ph = m | (~(xh | p) & _M32)
            mh = p & xh
            mask = top if w == W - 1 else msb
            ph_out = ((ph & mask) != 0).to(i64)
            mh_out = ((mh & mask) != 0).to(i64)
            ph = ((ph << 1) & _M32) | ph_in
            mh = ((mh << 1) & _M32) | mh_in
            pv[w] = mh | (~(xv | ph) & _M32)
            mv[w] = ph & xv
            ph_in, mh_in = ph_out, mh_out
        score = score + torch.where(t < tlen, ph_in - mh_in, 0)
    return score.to(torch.int32)
