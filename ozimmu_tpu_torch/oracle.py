"""The long-double host oracle (``csrc/oracle.cpp``), built with g++ and
bound with ctypes.

Port of ``ozimmu_tpu.native``'s error metrics: the same C++ (the reference's
``mateval`` role, test/main_test.cu:101-117) scores a computed GEMM against
an 80-bit long-double recomputation of it.  The library is compiled at
first use by ``g++ -O3 -fopenmp -shared -fPIC`` into
``ozimmu_tpu_torch/_build/`` (git-ignored); its file name carries a hash of
the source and the flags, so an edited source never loads a stale build.  A
failed build raises with the compiler's output: unlike the JAX package
there is no silent numpy fallback here (``testing.error_metrics`` is the
numpy oracle, for callers that ask for it).  Nothing runs at import time.

The multi-C entry points score up to 32 candidate results of one product
against ONE long-double accumulation, its dot products on the threads the
caller asks for and its sums in one fixed order, so their numbers do not
depend on the thread count; ctypes releases the interpreter lock during the
call, so several of them can run at once from a thread pool.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from .native import BUILD_DIR, compile_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "oracle.cpp")

#: no -march=native: the library must load on any x86-64 host the checkout
#: is copied to, and x87 long-double arithmetic has no FMA to gain anyway
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

#: the most candidates one multi-C call takes (NC_MAX in oracle.cpp)
MAX_CANDIDATES = 32

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liboz_oracle-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the oracle unless this exact build exists; return its path."""
    so = library_path()
    if not os.path.exists(so):
        compile_library(["g++", *GXX_FLAGS, _SRC], so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded oracle library, built on first call."""
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                loaded = ctypes.CDLL(build())
                i64, f64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_double)
                pp = ctypes.POINTER(f64p)
                for name in ("oz_error_metrics_d", "oz_error_metrics_z"):
                    getattr(loaded, name).argtypes = [i64, i64, i64, f64p, f64p, f64p, f64p]
                    getattr(loaded, name).restype = None
                multi = [i64, i64, i64, f64p, f64p, pp, i64, f64p, i64]
                loaded.oz_error_metrics_d_multi.argtypes = multi + [f64p]
                loaded.oz_error_metrics_z_multi.argtypes = multi
                for name in ("oz_error_metrics_d_multi", "oz_error_metrics_z_multi"):
                    getattr(loaded, name).restype = None
                _lib = loaded
    return _lib


def _f64p(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _as_f64(x: np.ndarray, complex_: bool) -> np.ndarray:
    """Contiguous float64 buffer (complex: interleaved re/im)."""
    if complex_:
        return np.ascontiguousarray(x, dtype=np.complex128).view(np.float64)
    return np.ascontiguousarray(x, dtype=np.float64)


def _metrics(out: np.ndarray, i: int) -> Dict[str, float]:
    return {"relative_residual": float(out[2 * i]), "max_relative_error": float(out[2 * i + 1])}


def _check_shapes(c_shape, a: np.ndarray, b: np.ndarray) -> None:
    m_n = (a.shape[0], b.shape[1]) if a.ndim == 2 and b.ndim == 2 else None
    if m_n is None or a.shape[1] != b.shape[0] or tuple(c_shape) != m_n:
        raise ValueError(f"oracle shapes: c {tuple(c_shape)} for a {a.shape} @ b {b.shape}")


def error_metrics(c: np.ndarray, a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """``relative_residual`` and ``max_relative_error`` of ``c`` against
    ``a @ b`` in long double (rows in parallel)."""
    _check_shapes(np.shape(c), a, b)
    cx = np.iscomplexobj(a) or np.iscomplexobj(b) or np.iscomplexobj(c)
    m, k = a.shape
    n = b.shape[1]
    ac, bc, cc = _as_f64(a, cx), _as_f64(b, cx), _as_f64(c, cx)
    out = np.zeros(2, dtype=np.float64)
    fn = lib().oz_error_metrics_z if cx else lib().oz_error_metrics_d
    fn(m, n, k, _f64p(ac), _f64p(bc), _f64p(cc), _f64p(out))
    return _metrics(out, 0)


def error_metrics_multi(
    cs: Sequence[np.ndarray], a: np.ndarray, b: np.ndarray, threads: int = 1,
    ref64: Optional[np.ndarray] = None,
) -> List[Dict[str, float]]:
    """Metrics of many candidate results of ``a @ b`` against one
    long-double accumulation (9x less oracle work when sweeping nine modes
    over the same operands); at most :data:`MAX_CANDIDATES`.  The dot
    products run on ``threads`` threads; the results do not depend on it.
    A real product also fills ``ref64`` (a C-contiguous float64 [m, n]
    array), when given, with the accumulation rounded to f64: the JAX
    package's ``native.ref_gemm_native``, from the same pass."""
    if not 1 <= len(cs) <= MAX_CANDIDATES:
        raise ValueError(f"1 to {MAX_CANDIDATES} candidates per call, got {len(cs)}")
    if threads < 1:
        raise ValueError(f"threads must be at least 1, got {threads}")
    for c in cs:
        _check_shapes(np.shape(c), a, b)
    cx = np.iscomplexobj(a) or np.iscomplexobj(b) or any(np.iscomplexobj(c) for c in cs)
    m, k = a.shape
    n = b.shape[1]
    if ref64 is not None and (cx or ref64.dtype != np.float64 or ref64.shape != (m, n)
                              or not ref64.flags.c_contiguous):
        raise ValueError(f"ref64 must be a C-contiguous float64 [{m}, {n}] array of a real "
                         "product")
    ac, btc = _as_f64(a, cx), _as_f64(b.T, cx)  # B transposed: contiguous dot products
    ccs = [_as_f64(c, cx) for c in cs]  # kept alive across the call
    ptrs = (ctypes.POINTER(ctypes.c_double) * len(ccs))(*[_f64p(c) for c in ccs])
    out = np.zeros(2 * len(ccs), dtype=np.float64)
    args = (m, n, k, _f64p(ac), _f64p(btc), ptrs, len(ccs), _f64p(out), threads)
    if cx:
        lib().oz_error_metrics_z_multi(*args)
    else:
        lib().oz_error_metrics_d_multi(*args, None if ref64 is None else _f64p(ref64))
    return [_metrics(out, i) for i in range(len(ccs))]
