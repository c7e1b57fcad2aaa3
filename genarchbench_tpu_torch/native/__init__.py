"""The port's native (C) host helpers, built with the system compiler.

At first use `wfa_cigars.c` is compiled with `cc -O3 -shared -fPIC`
(`$CC` overrides the compiler) into

    build/torch_native/<hash of the source and flags>/libgenarch_native.so

and loaded with ctypes.  The build goes into a private directory that is
renamed into place, so concurrent first uses never load a half-written
library, and an edited source is rebuilt.  A failed build raises with
the compiler's stderr: there is no Python fallback on the main path
(`kernels/wfa.py::_assemble_cigar` is the plain version the tests hold
this one to).
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

SRC = pathlib.Path(__file__).resolve().parent / "wfa_cigars.c"
BUILD_ROOT = SRC.parent.parent.parent / "build" / "torch_native"
LIB_NAME = "libgenarch_native.so"
CC_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([_compiler(), *CC_FLAGS]).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the helpers and return the library's path; a no-op when
    it is already built."""
    out = build_dir() / LIB_NAME
    if out.exists():
        return out
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        r = subprocess.run([_compiler(), *CC_FLAGS, "-o", str(tmp / LIB_NAME),
                            str(SRC)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{_compiler()} failed on {SRC.name}:\n"
                               f"{r.stderr}")
        try:
            os.replace(tmp, build_dir())
        except OSError:
            if not out.exists():   # not another process's finished build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded helper library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p32 = ctypes.POINTER(ctypes.c_int32)
            i64 = ctypes.c_int64
            lib.wfa_cigars.restype = ctypes.c_int
            lib.wfa_cigars.argtypes = [
                i64, i64, p32, ctypes.POINTER(ctypes.c_int8),
                p32, p32, p32, p32, p32, ctypes.c_char_p, i64, p32]
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
