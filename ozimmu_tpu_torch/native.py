"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use by ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so an edited source can never
load a stale build.  A failed build raises with nvcc's output: there is no
fallback.  Nothing here runs at import time — the CPU-only test machines
import this module but never build.

The build directory is ``ozimmu_tpu_torch/_build/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

#: sm_90a keeps the Hopper-only instructions open to later kernels;
#: --fmad=false because the triple-f32 fold must not contract into FMAs.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

#: nvcc's output of the build this process loaded (ptxas register and
#: shared-memory lines); empty when the library was already built.
build_log = ""


def sources() -> List[str]:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda: "
            "the CUDA kernels cannot be built"
        )
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liboz_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; return its path."""
    global build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cu = [s for s in sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    build_log = proc.stdout + proc.stderr
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.oz_split_digits.argtypes = [p, p, p, i64, i64, i32, i32, i32, p]
    lib.oz_split_digits.restype = i32
    lib.oz_recombine.argtypes = [p, p, p, p, p, i32, i32, i32, i32, p, p, p, p, p, p]
    lib.oz_recombine.restype = i32
    lib.oz_error_string.argtypes = [i32]
    lib.oz_error_string.restype = ctypes.c_char_p


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                loaded = ctypes.CDLL(build())
                _declare(loaded)
                _lib = loaded
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (its launch failed)."""
    if code != 0:
        msg = lib().oz_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
