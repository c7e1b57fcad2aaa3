"""The port's native (C) host helpers, built with the system compiler.

At first use the sources (`wfa_cigars.c`, `chain.c`, `sais.c`,
`peak_detect.c`, `poa_graph.c`, `minimizer.c`, `pileup_walk.c`) are
compiled with `cc -O3 -shared -fPIC` (`$CC` overrides the compiler) into
one library,

    build/torch_native/<hash of the sources and flags>/libgenarch_native.so

and loaded with ctypes.  The BGZF decoder (`bgzf_native.c`) and the
FASTA/FASTQ reader (`fasta_reader.c`) link zlib, so they are a second
library, `libgenarch_zlib.so`, built the same way: a host without
zlib's headers fails only the readers, not the other helpers.  A build
goes into a private directory that is renamed into place, so concurrent
first uses never load a half-written library, and an edited source is
rebuilt.  A failed build raises with the compiler's stderr: there is no
Python fallback on the main path (the plain versions the tests hold
these to are `kernels/wfa.py::_assemble_cigar`,
`ChainRecord.window_starts`, `kernels/chain.py::gap_corrections_plain`,
`kernels/fmi.py::suffix_array_plain`, `kernels/abea.py::_peak_detect`,
`kernels/poa.py::Graph`, `io/bam_io.py::bgzf_read_plain`,
`io/fasta_io.py::_read_fasta_py`, `kernels/kmer.py::_deque_scan_py` and
`kernels/pileup.py::_events_plain`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
SRCS = [_HERE / "wfa_cigars.c", _HERE / "chain.c", _HERE / "sais.c",
        _HERE / "peak_detect.c", _HERE / "poa_graph.c", _HERE / "minimizer.c",
        _HERE / "pileup_walk.c"]
BUILD_ROOT = _HERE.parent.parent / "build" / "torch_native"
LIB_NAME = "libgenarch_native.so"
CC_FLAGS = ["-O3", "-shared", "-fPIC"]
ZLIB_SRCS = [_HERE / "bgzf_native.c", _HERE / "fasta_reader.c"]
ZLIB_LIB_NAME = "libgenarch_zlib.so"
ZLIB_LIBS = ["-lz"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_zlib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def build_dir(srcs=None, libs=()) -> pathlib.Path:
    h = hashlib.sha256()
    for src in SRCS if srcs is None else srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([_compiler(), *CC_FLAGS, *libs]).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(srcs=None, name: str = LIB_NAME, libs=()) -> pathlib.Path:
    """Compile `srcs` (the helpers by default) into the library `name`,
    linked with `libs`, and return its path; a no-op when it is already
    built."""
    srcs = SRCS if srcs is None else srcs
    out = build_dir(srcs, libs) / name
    if out.exists():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        r = subprocess.run([_compiler(), *CC_FLAGS, "-o", str(tmp / name),
                            *map(str, srcs), *libs], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"{_compiler()} failed on {', '.join(s.name for s in srcs)}:"
                f"\n{r.stderr}")
        try:
            os.replace(tmp, build_dir(srcs, libs))
        except OSError:
            if not out.exists():   # not another process's finished build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def build_zlib() -> pathlib.Path:
    """The zlib-linked readers' library (BGZF, FASTA), built at first
    use."""
    return build(ZLIB_SRCS, ZLIB_LIB_NAME, ZLIB_LIBS)


def zlib_library() -> ctypes.CDLL:
    """The loaded zlib-linked readers, built at first use."""
    global _zlib
    with _lock:
        if _zlib is None:
            lib = ctypes.CDLL(str(build_zlib()))
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.bgzf_decompressed_size.restype = ctypes.c_int64
            lib.bgzf_decompressed_size.argtypes = [ctypes.c_char_p,
                                                   ctypes.c_int64]
            lib.bgzf_decompress.restype = ctypes.c_int64
            lib.bgzf_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.fasta_scan.restype = ctypes.c_int64
            lib.fasta_scan.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       p64, p64, p64]
            lib.fasta_load.restype = ctypes.c_int64
            lib.fasta_load.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), p64, ctypes.c_char_p]
            _zlib = lib
        return _zlib


def library() -> ctypes.CDLL:
    """The loaded helper library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p32 = ctypes.POINTER(ctypes.c_int32)
            p64 = ctypes.POINTER(ctypes.c_int64)
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.wfa_cigars.restype = ctypes.c_int
            lib.wfa_cigars.argtypes = [
                i64, i64, p32, ctypes.POINTER(ctypes.c_int8),
                p32, p32, p32, p32, p32, ctypes.c_char_p, i64, p32]
            lib.chain_window_starts.restype = None
            lib.chain_window_starts.argtypes = [
                i64, p64, ctypes.POINTER(ctypes.c_uint64), p64, i64, p32]
            lib.chain_gap_corr.restype = None
            lib.chain_gap_corr.argtypes = [
                i64, ctypes.POINTER(ctypes.c_float), i64, i64,
                ctypes.c_double, p32, p32, pu8]
            lib.chain_dp_scalar.restype = ctypes.c_int
            lib.chain_dp_scalar.argtypes = [
                i64, p64, p64, ctypes.POINTER(ctypes.c_double), p32, p32,
                p32, p32, ctypes.POINTER(ctypes.c_uint32), p32, pu8, pu8,
                p32, p32, p32, p32]
            lib.sais_u8.restype = ctypes.c_int
            lib.sais_u8.argtypes = [pu8, i64, i64, p64]
            pf32 = ctypes.POINTER(ctypes.c_float)
            lib.peak_detect.restype = i64
            lib.peak_detect.argtypes = [pf32, pf32, i64, ctypes.c_float,
                                        ctypes.c_float, i64, i64,
                                        ctypes.c_float, p64]
            vp = ctypes.c_void_p
            lib.poa_new.restype = vp
            lib.poa_new.argtypes = []
            lib.poa_free.restype = None
            lib.poa_free.argtypes = [vp]
            lib.poa_add_alignment.restype = ctypes.c_int
            lib.poa_add_alignment.argtypes = [
                vp, ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int16), i64, pu8, i64, ctypes.c_int]
            lib.poa_num_ranks.restype = i64
            lib.poa_num_ranks.argtypes = [vp]
            lib.poa_get_ranks.restype = None
            lib.poa_get_ranks.argtypes = [vp, p32]
            lib.poa_max_in_edges.restype = i64
            lib.poa_max_in_edges.argtypes = [vp]
            lib.poa_export_dp.restype = None
            lib.poa_export_dp.argtypes = [vp, i64, p32, p32, p32, pu8, p64,
                                          p64, i64, i64, i64, i64]
            lib.poa_consensus.restype = i64
            lib.poa_consensus.argtypes = [vp, pu8, i64]
            lib.minimizer_scan.restype = i64
            lib.minimizer_scan.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                           i64, i64, p64]
            lib.pileup_events.restype = i64
            lib.pileup_events.argtypes = [
                i64, p64, p32, p32, p32, p64, p32, p32, p64, pu8, pu8,
                ctypes.c_int32, i64, i64, ctypes.c_int32, p32, p64, pu8,
                p32, p32, p32, i64]
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def wfa_cigars(nmats: np.ndarray, ops: np.ndarray, gap_t: np.ndarray,
               gap_v: np.ndarray, fm: np.ndarray, fd: np.ndarray,
               fi: np.ndarray) -> List[str]:
    """RLE CIGARs from the wfa backtrace's records: nmats (B, T) match
    runs and ops (B, T) op codes in emission order, and the (B,) lane
    arrays gap_t, gap_v, fm, fd, fi (kernels/wfa.py::_assemble_cigar
    semantics, over all T steps)."""
    nmats = np.ascontiguousarray(nmats, np.int32)
    ops = np.ascontiguousarray(ops, np.int8)
    B, T = nmats.shape
    if ops.shape != (B, T):
        raise ValueError(f"ops must be {(B, T)}, got {ops.shape}")
    lanes = []
    for name, a in (("gap_t", gap_t), ("gap_v", gap_v), ("fm", fm),
                    ("fd", fd), ("fi", fi)):
        a = np.ascontiguousarray(a, np.int32)
        if a.shape != (B,):
            raise ValueError(f"{name} must be ({B},), got {a.shape}")
        lanes.append(a)
    # a step emits at most two runs (matches, op) and a lane five more
    # (the gap and the final runs), each at most 10 digits and its op
    stride = 22 * T + 64
    out = np.zeros((B, stride), np.uint8)
    outlen = np.zeros(B, np.int32)
    rc = library().wfa_cigars(
        B, T, _ptr(nmats, ctypes.c_int32), _ptr(ops, ctypes.c_int8),
        *(_ptr(a, ctypes.c_int32) for a in lanes),
        out.ctypes.data_as(ctypes.c_char_p), stride,
        _ptr(outlen, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError("wfa_cigars: out of memory" if rc < 0 else
                           f"wfa_cigars: lane {rc - 1}'s CIGAR overflowed "
                           f"{stride} bytes")
    return [out[b, :outlen[b]].tobytes().decode() for b in range(B)]


def _flat(name: str, a, dtype, n: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.shape != (n,):
        raise ValueError(f"{name} must be ({n},), got {a.shape}")
    return a


def chain_window_starts(offs: np.ndarray, x: np.ndarray, mdx: np.ndarray,
                        max_iter: int) -> np.ndarray:
    """Window starts (int32, flat like x) of the records whose sorted
    uint64 anchors x[offs[r]:offs[r + 1]] have max_dist_x mdx[r]."""
    offs = np.ascontiguousarray(offs, np.int64)
    nrec = len(offs) - 1
    if nrec < 0 or (np.diff(offs) < 0).any() or offs[0] != 0:
        raise ValueError("offs must be a non-decreasing offset list from 0")
    x = _flat("x", x, np.uint64, int(offs[-1]))
    mdx = _flat("mdx", mdx, np.int64, nrec)
    out = np.empty(len(x), np.int32)
    library().chain_window_starts(
        nrec, _ptr(offs, ctypes.c_int64), _ptr(x, ctypes.c_uint64),
        _ptr(mdx, ctypes.c_int64), max_iter, _ptr(out, ctypes.c_int32))
    return out


def chain_gap_corr(avg32: np.ndarray, t_size: int, ck: int,
                   safe_prod: float):
    """Sparse f32-vs-f64 gap-cost corrections for dd in [0, t_size):
    (corr_dd (nb, ck) int32 with -1 in unused slots, corr_delta (nb, ck)
    int32, over (nb,) bool: rows that need chain_dp_scalar)."""
    avg32 = np.ascontiguousarray(avg32, np.float32).ravel()
    nb = len(avg32)
    corr_dd = np.full((nb, ck), -1, np.int32)
    corr_delta = np.zeros((nb, ck), np.int32)
    over = np.zeros(nb, np.uint8)
    library().chain_gap_corr(
        nb, _ptr(avg32, ctypes.c_float), t_size, ck, safe_prod,
        _ptr(corr_dd, ctypes.c_int32), _ptr(corr_delta, ctypes.c_int32),
        _ptr(over, ctypes.c_uint8))
    return corr_dd, corr_delta, over.astype(bool)


def chain_dp_scalar(ns, avg, mdx, mdy, bw, nsegs, x_lo, qi, span, sid, st):
    """The exact scalar chain DP over records laid end to end: record b
    has ns[b] anchors, per-record parameters avg (the f32 avg_qspan),
    mdx, mdy, bw, nsegs, and flat anchor planes x_lo (uint32), qi,
    span and sid (uint8) and window starts st.  Returns flat
    (scores, parents, peaks) int32."""
    ns = np.ascontiguousarray(ns, np.int64)
    B = len(ns)
    if (ns < 0).any():
        raise ValueError("ns must be non-negative")
    offs = np.zeros(B, np.int64)
    np.cumsum(ns[:-1], out=offs[1:])
    M = int(ns.sum())
    avg = _flat("avg", avg, np.float64, B)
    per = [_flat(nm, a, np.int32, B) for nm, a in
           (("mdx", mdx), ("mdy", mdy), ("bw", bw), ("nsegs", nsegs))]
    x_lo = _flat("x_lo", x_lo, np.uint32, M)
    qi = _flat("qi", qi, np.int32, M)
    span = _flat("span", span, np.uint8, M)
    sid = _flat("sid", sid, np.uint8, M)
    st = _flat("st", st, np.int32, M)
    if ((st < 0) | (st > np.arange(M) - np.repeat(offs, ns))).any():
        raise ValueError("window starts must lie in [0, i]")
    scores = np.zeros(M, np.int32)
    parents = np.zeros(M, np.int32)
    peaks = np.zeros(M, np.int32)
    rc = library().chain_dp_scalar(
        B, _ptr(ns, ctypes.c_int64), _ptr(offs, ctypes.c_int64),
        _ptr(avg, ctypes.c_double), *(_ptr(a, ctypes.c_int32) for a in per),
        _ptr(x_lo, ctypes.c_uint32), _ptr(qi, ctypes.c_int32),
        _ptr(span, ctypes.c_uint8), _ptr(sid, ctypes.c_uint8),
        _ptr(st, ctypes.c_int32), _ptr(scores, ctypes.c_int32),
        _ptr(parents, ctypes.c_int32), _ptr(peaks, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError("chain_dp_scalar: out of memory")
    return scores, parents, peaks


def sais(codes: np.ndarray) -> np.ndarray:
    """Suffix array (int64) of `codes` (values below 255) by linear-time
    SA-IS in C (`sais.c`), in shorter-suffix-first order: the codes are
    shifted up by one, a unique smallest sentinel 0 is appended, and the
    sentinel's own row SA[0] is dropped."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if len(codes) and int(codes.max()) >= 255:
        raise ValueError("sais: codes must be below 255")
    n = len(codes)
    text = np.empty(n + 1, np.uint8)
    text[:n] = codes + 1
    text[n] = 0
    sa = np.empty(n + 1, np.int64)
    rc = library().sais_u8(_ptr(text, ctypes.c_uint8), n + 1,
                           int(text.max()) + 1, _ptr(sa, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError("sais: out of memory")
    return sa[1:]


def peak_detect(t1: np.ndarray, t2: np.ndarray, thr1: float, thr2: float,
                wl1: int, wl2: int, peak_height: float) -> np.ndarray:
    """The sample positions (int64) of the peaks that abea's two-detector
    peak finder (`peak_detect.c`) picks from the short- and long-window
    t-statistics t1 and t2 (float32, one value a sample)."""
    t1 = np.ascontiguousarray(t1, np.float32)
    t2 = np.ascontiguousarray(t2, np.float32)
    if t1.ndim != 1 or t2.shape != t1.shape:
        raise ValueError(f"t1 and t2 must be one 1-D shape, got {t1.shape} "
                         f"and {t2.shape}")
    out = np.zeros(len(t1), np.int64)
    pc = library().peak_detect(_ptr(t1, ctypes.c_float),
                               _ptr(t2, ctypes.c_float), len(t1), thr1, thr2,
                               wl1, wl2, peak_height,
                               _ptr(out, ctypes.c_int64))
    return out[:pc]


def bgzf_decompress(raw: bytes) -> bytes:
    """Every BGZF block of `raw` inflated and concatenated (C and zlib,
    `bgzf_native.c`); raises ValueError on a framing or inflate error."""
    lib = zlib_library()
    n = lib.bgzf_decompressed_size(raw, len(raw))
    if n < 0:
        raise ValueError("bgzf: bad BGZF framing")
    buf = np.empty(n, np.uint8)
    w = lib.bgzf_decompress(raw, len(raw), _ptr(buf, ctypes.c_uint8), n)
    if w != n:
        raise ValueError(f"bgzf: inflated {w} bytes of the {n} the blocks "
                         "announce")
    return buf.tobytes()


def fasta_read(path: str, min_len: int):
    """(names, [uint8 code arrays]) of the records of a FASTA or FASTQ
    file (gzip or plain) longer than `min_len`, in file order, ACGT (and
    acgt) encoded 0..3 and every other base 3 (`fasta_reader.c`'s table
    0), in C and zlib; raises OSError when the file cannot be read."""
    lib = zlib_library()
    n, bases, namebytes = (ctypes.c_int64() for _ in range(3))
    bpath = os.fsencode(path)
    if lib.fasta_scan(bpath, min_len, ctypes.byref(n), ctypes.byref(bases),
                      ctypes.byref(namebytes)) != 0:
        raise OSError(f"fasta_read: cannot read {path}")
    codes = np.empty(bases.value, np.uint8)
    offsets = np.zeros(n.value + 1, np.int64)
    names = ctypes.create_string_buffer(max(namebytes.value, 1))
    got = lib.fasta_load(bpath, min_len, 0, _ptr(codes, ctypes.c_uint8),
                         _ptr(offsets, ctypes.c_int64), names)
    if got != n.value:
        raise OSError(f"fasta_read: {path} gave {got} records on the second "
                      f"pass, {n.value} on the first")
    return (names.raw[:namebytes.value].decode().splitlines(),
            [codes[offsets[i]:offsets[i + 1]] for i in range(n.value)])


def minimizer_scan(h: np.ndarray, window: int) -> np.ndarray:
    """Positions (int64) of the minimizers of the uint64 hashes `h` over
    windows of `window` (Flye's yieldMinimizers deque, `minimizer.c`)."""
    h = np.ascontiguousarray(h, np.uint64)
    out = np.empty(max(len(h), 1), np.int64)
    m = library().minimizer_scan(_ptr(h, ctypes.c_uint64), len(h), window,
                                 _ptr(out, ctypes.c_int64))
    if m < 0:
        raise RuntimeError("minimizer_scan: out of memory")
    return out[:m]


def pileup_events(flat, chrom_id: int, start: int, end: int,
                  filter_flags: int, num2countbase: np.ndarray):
    """One pileup chunk's walk over the records of `flat` (the tuple of
    kernels/pileup.py::_flatten_records), in C (`pileup_walk.c`):
    (cov int64, present bool, ev_p, ev_j, ev_f int32), cov and present
    over [start, end), the events' positions chunk-relative."""
    (n, rpos, rflag, rmapq, rrefid, cig_off, cig_op, cig_len,
     seq_off, nt16, qual) = flat
    span = end - start
    cov = np.full(span, -1, np.int64)
    present = np.zeros(span, np.uint8)
    n2c = np.ascontiguousarray(num2countbase, np.int32)
    lib = library()

    def walk(ev_p, ev_j, ev_f, cap):
        return lib.pileup_events(
            n, _ptr(rpos, ctypes.c_int64), _ptr(rflag, ctypes.c_int32),
            _ptr(rmapq, ctypes.c_int32), _ptr(rrefid, ctypes.c_int32),
            _ptr(cig_off, ctypes.c_int64), _ptr(cig_op, ctypes.c_int32),
            _ptr(cig_len, ctypes.c_int32), _ptr(seq_off, ctypes.c_int64),
            _ptr(nt16, ctypes.c_uint8), _ptr(qual, ctypes.c_uint8),
            chrom_id, start, end, filter_flags, _ptr(n2c, ctypes.c_int32),
            _ptr(cov, ctypes.c_int64), _ptr(present, ctypes.c_uint8),
            _ptr(ev_p, ctypes.c_int32), _ptr(ev_j, ctypes.c_int32),
            _ptr(ev_f, ctypes.c_int32), cap)

    none = np.zeros(1, np.int32)
    m = walk(none, none, none, 0)
    cov[:] = -1
    present[:] = 0
    ev = [np.empty(max(m, 1), np.int32) for _ in range(3)]
    if walk(*ev, m) != m:
        raise RuntimeError("pileup_events: the two passes disagree")
    return (cov, present.astype(bool), *(e[:m] for e in ev))
