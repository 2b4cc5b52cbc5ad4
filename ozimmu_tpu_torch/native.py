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


def compile_library(cmd: List[str], so: str) -> str:
    """Run the compiler command ``cmd`` (which lacks only ``-o``) to build
    the shared library ``so``; return the compiler's output.  Raises with
    that output if the compiler fails or is missing."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    full = [*cmd, "-o", tmp]
    try:
        proc = subprocess.run(full, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{cmd[0]} not found: cannot build {os.path.basename(so)}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed ({proc.returncode}): {' '.join(full)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return proc.stdout + proc.stderr


def build() -> str:
    """Compile the kernels unless this exact build exists; return its path.
    One ``nvcc -c`` per source, all started together, then one link."""
    global build_log
    so = library_path()
    if not os.path.exists(so):
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        cu = [s for s in sources() if s.endswith(".cu")]
        objs = [f"{so}.{os.path.basename(s)}.{os.getpid()}.o" for s in cu]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [
            subprocess.Popen([nvcc, *flags, "-c", s, "-o", o],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cu, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        try:
            for s, p, log in zip(cu, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({p.returncode}) on {os.path.basename(s)}\n{log}")
            build_log = "".join(logs) + compile_library([nvcc, *NVCC_FLAGS, *objs], so)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.oz_split_digits.argtypes = [
        p, p, p, i64, i64, i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i64, i32, p,
    ]
    lib.oz_split_digits.restype = i32
    lib.oz_exponent_max.argtypes = [p, p, i64, i64, i64, i64, i64, i32, i32, i64, i64, p]
    lib.oz_exponent_max.restype = i32
    lib.oz_recombine.argtypes = [
        p, p, p, p, p, i32, i32, i32, i32, i32, i32, p, p, p, p, p, i32, i32, i32, p,
    ]
    lib.oz_recombine.restype = i32
    lib.oz_epilogue.argtypes = [
        p, p, p, p, i32, i64, i64, i64, p, p, i32, p, i32, i32, p, i64, i64, p, i64, p,
    ]
    lib.oz_epilogue.restype = i32
    lib.oz_zfold.argtypes = [
        p, p, p, i32, i64, i64, p, p, p, p, p, p, i64, i64, i32, i32, p, p, p,
    ]
    lib.oz_zfold.restype = i32
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
