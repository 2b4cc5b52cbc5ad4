"""Host-side (numpy) reference engine: exact Ozaki split + recombination.

The port's own copy of ``ozimmu_tpu.hostref``: a numpy model of the
engine, independent of its torch code and of the CUDA kernels, which the
engine is validated against.  It takes no device and has no torch in its
arithmetic.  It re-derives — does not translate — the semantics of the
reference CUDA kernels:

  - digit extraction: reference src/split.cu:154-242 (``cut_int8_core`` /
    ``split_int8_kernel``): per-row max-exponent, doubled (``x2``,
    split.cu:187-191), then the 53-bit significand shifted by the exponent
    gap and chopped into ``ns`` sign-magnitude b-bit digits.
    Here this is vectorized uint64 numpy bit arithmetic.
  - recombination: reference src/gemm.cu:344-410 accumulates each pair's
    int32 GEMM into f64 with weight ``2^(2 - b(i+j))`` in ascending
    ``i+j`` order.  Here pairs with equal ``i+j`` are pre-summed (same
    weight) and the weighted series is accumulated in extended precision
    (longdouble) before a single rounding to f64 — strictly tighter than
    the reference's per-step f64 rounding.

Exactness notes:
  * Digit products are computed with f64 BLAS matmuls: digits are < 2^7 and
    ``k * 127^2 < 2^31 << 2^53`` so every dot product is exact in f64.
  * Subnormal inputs follow reference semantics: exponent field 0 means no
    implicit bit (split.cu:160-162); a row whose max exponent field is 0
    produces zero digits and a zero row scale (split.cu:203 with
    ``mask_exponent == 0``).
  * The engine's own null-row sentinel (``ops.split.ZERO_ROW_PEXP``) is
    another number than :data:`ZERO_ROW_PEXP` here; both null the row.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .schedule import bits_per_int8, group_schedule

#: Row-scale exponent sentinel for all-zero/subnormal rows: the reference
#: stores ``max_exp = 0.0`` which nulls the row in the epilogue
#: (gemm.cu:124-158).  We store an exponent so small that ldexp underflows
#: to exactly 0.0.
ZERO_ROW_PEXP = -(10**6)

_MANT_MASK = np.uint64((1 << 52) - 1)
_IMPLICIT = np.uint64(1 << 52)


def split_fp64(
    x: np.ndarray, num_split: int, b: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Split ``x`` [rows, k] (f64) into sign-magnitude int8 digit planes.

    Returns ``(digits, pexp)`` where ``digits`` is int8 ``[ns, rows, k]``
    with digit ``i`` (1-indexed slice ``i = plane+1``) holding ``b`` bits,
    and ``pexp`` is int64 ``[rows]`` such that the row scale is
    ``2^pexp[r]`` (``ZERO_ROW_PEXP`` for all-zero rows).

    Identity (exact): for every element with exponent gap
    ``d = pexp[r] - unbiased_exp(x) - 1 >= 0``::

        x[r, c] == 2^pexp[r] * sum_i digits[i-1, r, c] * 2^(1 - i*b)

    whenever ``ns*b >= 53 + d`` (no truncated mantissa bits).
    """
    if x.dtype != np.float64:
        raise TypeError(f"split_fp64 expects float64, got {x.dtype}")
    rows, k = x.shape
    bits = np.ascontiguousarray(x).view(np.uint64)
    sign_pos = x > 0  # reference split.cu:159: sign_flag = (a > 0)
    E = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    mant = bits & _MANT_MASK
    m53 = np.where(E > 0, mant | _IMPLICIT, mant)

    Erow = E.max(axis=1)
    # max_exp = 2 * 2^(Erow - 1023) = 2^(Erow - 1022)  (split.cu:187-204)
    pexp = np.where(Erow > 0, Erow - 1022, ZERO_ROW_PEXP)

    # Exponent gap incl. the x2 doubling: shift = (Erow + 1) - E.
    delta = (Erow + 1)[:, None] - E  # [rows, k], >= 1 where Erow > 0
    mask = np.uint64((1 << b) - 1)
    digits = np.empty((num_split, rows, k), dtype=np.int8)
    sign = np.where(sign_pos, np.int8(1), np.int8(-1))
    for plane in range(num_split):
        i = plane + 1
        r = 53 + delta - i * b  # window LSB position within m53
        rpos = np.clip(r, 0, 63).astype(np.uint64)
        rneg = np.clip(-r, 0, 63).astype(np.uint64)
        win = np.where(
            r >= 64,
            np.uint64(0),
            np.where(r >= 0, m53 >> rpos, m53 << rneg) & mask,
        )
        digits[plane] = win.astype(np.int8) * sign
    zero_rows = Erow == 0
    if zero_rows.any():
        digits[:, zero_rows, :] = 0
    return digits, pexp


def reconstruct_fp64(digits: np.ndarray, pexp: np.ndarray, b: int) -> np.ndarray:
    """Inverse of :func:`split_fp64` up to truncation (testing helper)."""
    ns, rows, k = digits.shape
    acc = np.zeros((rows, k), dtype=np.longdouble)
    for plane in range(ns):
        i = plane + 1
        acc += digits[plane].astype(np.longdouble) * np.longdouble(2.0) ** (1 - i * b)
    scale = np.where(
        pexp == ZERO_ROW_PEXP, np.longdouble(0), np.longdouble(2.0) ** pexp.astype(np.longdouble)
    )
    return (acc * scale[:, None]).astype(np.float64)


def _pair_products_sum(
    da: np.ndarray, db: np.ndarray, pairs
) -> np.ndarray:
    """Sum of exact digit-plane products for the given 1-indexed pairs."""
    m = da.shape[1]
    n = db.shape[2]
    acc = np.zeros((m, n), dtype=np.float64)
    for i, j in pairs:
        # exact: |dot| <= k * 127^2 < 2^31 << 2^53
        acc += da[i - 1].astype(np.float64) @ db[j - 1].astype(np.float64)
    return acc


def gemm_core_fp64(
    da: np.ndarray,
    pa: np.ndarray,
    db: np.ndarray,
    pb: np.ndarray,
    b: int,
    k_for_schedule: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Recombine digit planes into the scaled accumulation ``S``.

    Returns ``(S, pexp_sum)`` with the mathematical result
    ``C = S * 2^(pa[:,None] + pb[None,:])`` where ``S`` is f64 [m, n]
    accumulated in extended precision and rounded once.
    """
    ns = da.shape[0]
    groups = group_schedule(ns, k_for_schedule, b)
    S = np.zeros((da.shape[1], db.shape[2]), dtype=np.longdouble)
    for g in groups:
        d = _pair_products_sum(da, db, g.pairs)
        S += d.astype(np.longdouble) * np.longdouble(2.0) ** g.weight_log2(b)
    pexp_sum = pa[:, None] + pb[None, :]
    return S.astype(np.float64), pexp_sum


def _apply_epilogue(
    S: np.ndarray,
    pexp_sum: np.ndarray,
    alpha: float,
    beta: float,
    c: np.ndarray | None,
) -> np.ndarray:
    x = np.ldexp(S, np.clip(pexp_sum, -(2**30), 2**30).astype(np.int64))
    if beta == 0 or c is None:
        return alpha * x
    return alpha * x + beta * c


def gemm_fp64(
    a: np.ndarray,
    b_mat: np.ndarray,
    num_split: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: np.ndarray | None = None,
) -> np.ndarray:
    """Emulated FP64 GEMM: ``alpha * (a @ b_mat) + beta * c``.

    ``a`` is [m, k], ``b_mat`` is [k, n], both float64 (logical row-major;
    transposes must be applied by the caller).
    """
    m, k = a.shape
    k2, n = b_mat.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {a.shape} @ {b_mat.shape}")
    b = bits_per_int8(k)
    if b <= 0:
        raise ValueError(f"k={k} too large for int8 emulation")
    da, pa = split_fp64(a, num_split, b)
    # B is split along columns: per-column max exponent == per-row of B^T.
    dbt, pb = split_fp64(np.ascontiguousarray(b_mat.T), num_split, b)
    db = np.ascontiguousarray(np.swapaxes(dbt, 1, 2))
    S, pexp_sum = gemm_core_fp64(da, pa, db, pb, b, k)
    return _apply_epilogue(S, pexp_sum, alpha, beta, c)


def zgemm_fp64(
    a: np.ndarray,
    b_mat: np.ndarray,
    num_split: int,
    alpha: complex = 1.0 + 0j,
    beta: complex = 0.0 + 0j,
    c: np.ndarray | None = None,
) -> np.ndarray:
    """Emulated complex FP64 GEMM via the 4-pass real engine.

    Mirrors reference gemm.cu:412-521: passes over (A-part, B-part) in
    {(im,im), (re,re), (im,re), (re,im)} with sign-twiddled alpha folds.
    """
    m, k = a.shape
    _, n = b_mat.shape
    b = bits_per_int8(k)
    da_re, pa_re = split_fp64(np.ascontiguousarray(a.real), num_split, b)
    da_im, pa_im = split_fp64(np.ascontiguousarray(a.imag), num_split, b)
    dbt_re, pb_re = split_fp64(np.ascontiguousarray(b_mat.T.real), num_split, b)
    dbt_im, pb_im = split_fp64(np.ascontiguousarray(b_mat.T.imag), num_split, b)
    db_re = np.ascontiguousarray(np.swapaxes(dbt_re, 1, 2))
    db_im = np.ascontiguousarray(np.swapaxes(dbt_im, 1, 2))

    out = np.zeros((m, n), dtype=np.complex128)
    if beta != 0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        out = beta * c

    passes = [(1, 1), (0, 0), (1, 0), (0, 1)]  # (A-part, B-part); 0=re, 1=im
    a_planes = {0: (da_re, pa_re), 1: (da_im, pa_im)}
    b_planes = {0: (db_re, pb_re), 1: (db_im, pb_im)}
    for ap, bp in passes:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        S, pexp_sum = gemm_core_fp64(da, pa, db, pb, b, k)
        x = np.ldexp(S, np.clip(pexp_sum, -(2**30), 2**30).astype(np.int64))
        if ap == 0 and bp == 0:
            fold = alpha
        elif ap == 1 and bp == 1:
            fold = -alpha
        else:  # cross terms carry i: alpha * i = (-alpha.imag, alpha.real)
            fold = complex(-alpha.imag, alpha.real)
        out = out + fold * x
    return out
