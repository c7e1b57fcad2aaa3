"""Build and load the hand-written CUDA kernels (csrc/*.cu).

At first use each source is compiled by its own `nvcc` process, all of
them at once, for `sm_90a`, and the objects are linked into one shared
library with a plain C interface:

    build/torch_kernels/<hash of the sources>/libgenarch_kernels.so

which is then loaded with ctypes.  The directory name changes with the
sources, so an edited kernel is rebuilt and a stale library is never
loaded.  `ptxas.txt` beside the library keeps what `-Xptxas -v` said of
each kernel (registers, shared memory, spills).

Each C entry point returns `cudaGetLastError()` after its launch;
`check` raises on anything but 0.
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
from typing import Optional

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libgenarch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda/bin, or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "cannot build the CUDA kernels: no nvcc in $CUDA_HOME/bin, "
        "/usr/local/cuda/bin or PATH")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link the
    library; returns its path.  A no-op when it is already built."""
    out = build_dir() / LIB_NAME
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    # build in a private directory and rename it into place, so that
    # concurrent first uses never load a half-written library
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, objs, failed = [], [], []
        for src, obj, p in procs:
            so, se = p.communicate()
            logs.append(f"== {src.name}\n{so}{se}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{se}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp / LIB_NAME),
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        (tmp / "ptxas.txt").write_text("".join(logs))
        try:
            os.replace(tmp, build_dir())
        except OSError:
            if not out.exists():   # not another process's finished build
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.genarch_cuda_error_string.argtypes = [ctypes.c_int]
            lib.genarch_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().genarch_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
