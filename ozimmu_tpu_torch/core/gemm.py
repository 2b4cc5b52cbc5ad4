"""The GEMM engine: split -> recombination -> exact epilogue.

Port of ``ozimmu_tpu.core.gemm`` (real path), the equivalent of the
reference orchestration layer (src/gemm.cu:344-521 ``gemm_int8<double>``):

  * equal-weight slice pairs are summed in int32 before any float work
    (ops/recombine.py);
  * the epilogue (alpha/beta folding, reference gemm.cu:124-239) runs in
    triple-f32 extended precision with a single final rounding.

Operands are float64 tensors; every step runs on the operands' device.
On a CUDA device the split and the recombination are the hand-written
kernels (ops/split_cuda.py, ops/recombine_cuda.py); on the CPU, their
plain PyTorch versions.

Layout contract: row-major logical matrices.  ``gemm_f64(a, b)`` computes
``alpha * (a @ b) + beta * c`` for a [m, k] and b [k, n].  Transpose flags
are applied by the public API (core/api.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import tf32x3
from ..ops.pack import aligned_add, pack_f64, scalar_triple, unpack_f64
from ..ops.recombine import acc_shift, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import auto_n_chunks, bits_per_int8


def _epilogue_SE(S, E, alpha: float, beta: float, c: Optional[torch.Tensor]) -> torch.Tensor:
    """``alpha * (S * 2^E) + beta * c`` in extended precision, rounded to
    f64 once (reference axby, gemm.cu:124-158)."""
    dev = E.device
    if alpha != 1.0:
        at, ae = scalar_triple(alpha, device=dev)
        S = tf32x3.mul(S, at)
        E = E + ae
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        ct, cE = unpack_f64(c)
        if beta != 1.0:
            bt, be = scalar_triple(beta, device=dev)
            ct = tf32x3.mul(ct, bt)
            cE = cE + be
        S, E = aligned_add(S, E, ct, cE)
    return pack_f64(S, E)


def _exponent_plane(pa: torch.Tensor, pb: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 ``pa[:, None] + pb[None, :] - shift`` (int32 so that the
    ZERO_ROW_PEXP sentinel arithmetic matches the JAX package's)."""
    return (pa[:, None] + pb[None, :] - shift).to(torch.int32)


def _gemm_core(a, b, num_split: int, alpha: float, beta: float, c=None) -> torch.Tensor:
    """Real-valued engine core on one device."""
    k = a.shape[1]
    bb = bits_per_int8(k)
    da, pa = split_f64(a, num_split, bb)
    db, pb = split_f64_cols(b, num_split, bb)
    S = recombine(da, db, num_split, bb, k)
    E = _exponent_plane(pa, pb, acc_shift(num_split, bb))
    return _epilogue_SE(S, E, alpha, beta, c)


def _gemm_core_nchunked(a, b, num_split: int, n_chunks: int, alpha: float = 1.0,
                        beta: float = 0.0, c=None) -> torch.Tensor:
    """Column-panel-chunked engine: split A once, stream B in n panels.

    Bitwise-identical to :func:`_gemm_core` (B's split is per-column
    independent, the recombination sees the full k, and the epilogue is
    elementwise), but peak memory for the B planes / int32 partials /
    triple-f32 accumulator drops by ~n_chunks.  Any ``n`` (the last panel
    is simply narrower).
    """
    k = a.shape[1]
    n = b.shape[1]
    if n == 0:
        return _gemm_core(a, b, num_split, alpha, beta, c)
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    shift = acc_shift(num_split, bb)
    da, pa = split_f64(a, num_split, bb)
    out = torch.empty((a.shape[0], n), dtype=torch.float64, device=a.device)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        db, pb = split_f64_cols(b[:, j0:j1].contiguous(), num_split, bb)
        S = recombine(da, db, num_split, bb, k)
        E = _exponent_plane(pa, pb, shift)
        cj = c[:, j0:j1] if c is not None else None
        out[:, j0:j1] = _epilogue_SE(S, E, alpha, beta, cj)
    return out


def gemm_f64(
    a: torch.Tensor,
    b: torch.Tensor,
    num_split: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    n_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Emulated FP64 GEMM on float64 tensors: alpha*(a@b) + beta*c.

    ``a`` [m, k], ``b`` [k, n] (and ``c`` [m, n]) must lie on one device.
    ``n_chunks=None`` auto-selects column-panel streaming from the
    working-set estimate against that device's memory
    (schedule.auto_n_chunks); 1 forces the unchunked engine.  Chunked and
    unchunked results are bitwise identical.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"gemm_f64 takes float64 tensors, got {a.dtype} and {b.dtype}")
    if bits_per_int8(a.shape[1]) <= 0:
        raise ValueError(f"k={a.shape[1]} too large for int8 emulation")
    if b.device != a.device or (c is not None and c.device != a.device):
        raise ValueError("a, b and c must lie on one device")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    if n_chunks is None:
        n_chunks = auto_n_chunks(m, n, k, num_split, device=a.device)
    if n_chunks > 1:
        return _gemm_core_nchunked(a, b, num_split, n_chunks, float(alpha), float(beta), c)
    return _gemm_core(a, b, num_split, float(alpha), float(beta), c)
