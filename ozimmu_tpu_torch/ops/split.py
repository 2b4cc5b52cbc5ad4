"""Mantissa split: exact f64 bits -> sign-magnitude int8 digit planes.

Semantics parity with the reference (src/split.cu:154-242) and with
``ozimmu_tpu.ops.split``:
  * per-row max exponent, doubled (``x2``, split.cu:187-204):
    row scale is ``2^(Erow - 1022)``;
  * digit ``i`` (1-indexed) is bits ``[r, r+b)`` of the 53-bit significand
    where ``r = 53 + (Erow + 1 - E) - i*b`` (split.cu:154-185);
  * exponent-field-0 elements keep their raw mantissa with no implicit
    bit (split.cu:160-162); rows whose max exponent field is 0 produce
    zero digits and a nulled row scale (split.cu:203).

Exactness identity:

    x[r, c] == 2^pexp[r] * sum_i digits[i-1, r, c] * 2^(1 - i*b)

whenever ``ns*b >= 53 + (Erow - E)``.

:func:`split_with_row_exp` is the plain PyTorch version of the CUDA kernel
in :mod:`.split_cuda`, :func:`row_exponent_plain` that of the exponent-max
kernel in :mod:`.exponent_cuda`.  :func:`row_exponent`,
:func:`split_with_exp`, :func:`split_f64` and :func:`split_f64_cols` pick
by the operand's device alone: a CUDA tensor always goes through the
kernels, a CPU tensor through the plain versions.

Plane layouts: without ``k_pad`` the planes keep the operand's layout,
[ns, rows, k] for A and [ns, k, cols] for B (the JAX package's).  With
``k_pad`` (a multiple of 16, at least k) both come k-major and zero beyond
k, as the recombine kernel reads them: A [ns, rows, k_pad] and B
[ns, cols, k_pad] — B's split writes its planes transposed, so nothing
copies them again.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.bits import exponent_field, mantissa53, sign_bit
from ..utils.profiling import span

#: pexp value for all-zero/subnormal rows; any int that the pack
#: exponent clamp turns into a hard underflow (exact 0.0).
ZERO_ROW_PEXP = -(2**20)


def row_exponent_plain(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Max biased exponent field (int32) along the contraction axis of a
    matrix [R, C] or of each matrix of a batch [B, R, C]: one per row
    (``axis=1``) or one per column (``axis=0``)."""
    return torch.amax(exponent_field(x), dim=axis - 2)


def row_exponent(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """:func:`row_exponent_plain` on ``x``'s device: the CUDA kernel for a
    CUDA tensor (one launch, also for a batch or a strided column panel),
    the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        from .exponent_cuda import exponent_max

        return exponent_max(x, axis)
    if x.device.type == "cpu":
        return row_exponent_plain(x, axis)
    raise ValueError(f"unsupported device {x.device}")


def pexp_from_row_exp(e_row: torch.Tensor) -> torch.Tensor:
    """Row (or column) scale exponent: ``2^pexp`` scales the digits."""
    return torch.where(
        e_row > 0, e_row - 1022, torch.full_like(e_row, ZERO_ROW_PEXP)
    ).to(torch.int32)


def split_with_row_exp(
    x: torch.Tensor, e_row: torch.Tensor, num_split: int, b: int, axis: int = 1,
    k_pad: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split against a supplied max exponent along ``axis``.

    ``axis=1``: x is [rows, k], one scale per row (the A operand).
    ``axis=0``: x is [k, cols], one scale per column (the B operand) —
    digits come out in the matrix's natural layout.

    Returns ``(digits, pexp)``: int8 ``[ns, rows, cols]`` and int32
    ``[rows]`` (axis=1) or ``[cols]`` (axis=0).  A batch ``x`` [B, rows,
    cols] with ``e_row`` [B, rows] or [B, cols] gives int8 ``[ns, B, rows,
    cols]``, each matrix split as on its own.  ``k_pad`` gives the
    k-major layout instead (module docstring): the same digits transposed
    (B) and zero-padded to ``k_pad``.  Each window is cut from the int64
    53-bit significand; all shift counts are clamped into [0, 62], which
    keeps the semantics because the significand is below 2^53 and windows
    reaching below bit -b are zero.
    """
    e_row = e_row.to(torch.int32)
    bcast = (..., slice(None), None) if axis == 1 else (..., None, slice(None))
    m53 = mantissa53(x)
    neg = sign_bit(x) == 1
    delta = (e_row + 1)[bcast].to(torch.int64) - exponent_field(x).to(torch.int64)
    nonzero = (e_row > 0)[bcast]
    mask = (1 << b) - 1
    digits = torch.empty((num_split,) + tuple(x.shape), dtype=torch.int8, device=x.device)
    for plane in range(num_split):
        r = 53 + delta - (plane + 1) * b  # window LSB position
        from_above = m53 >> torch.clamp(r, 0, 62)
        from_below = m53 << torch.clamp(-r, 0, b)
        win = torch.where(r >= 0, from_above, from_below) & mask
        win = torch.where((r > -b) & nonzero, win, torch.zeros_like(win))
        digits[plane] = torch.where(neg, -win, win).to(torch.int8)
    if k_pad is not None:
        digits = _as_k_major(digits, axis, k_pad)
    return digits, pexp_from_row_exp(e_row)


def _as_k_major(digits: torch.Tensor, axis: int, k_pad: int) -> torch.Tensor:
    """Planes [ns, ..., rows, k] (axis=1) or [ns, ..., k, cols] (axis=0) as
    contiguous [ns, ..., rows or cols, k_pad], zero beyond k."""
    if axis == 0:
        digits = digits.transpose(-1, -2)
    k = digits.shape[-1]
    if k_pad % 16 or k_pad < k:
        raise ValueError(f"k_pad={k_pad} is not a multiple of 16 at least k={k}")
    return F.pad(digits, (0, k_pad - k)).contiguous()


def split_with_exp(
    x: torch.Tensor, e_max: torch.Tensor, num_split: int, b: int, axis: int = 1,
    k_pad: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`split_with_row_exp` on ``x``'s device: the CUDA kernel for a
    CUDA tensor (one launch, also for a batch; ``x`` read through its
    strides), the plain version for a CPU tensor.  ``e_max`` is the max
    exponent field along ``axis`` (the distributed layer passes the max
    over every rank's block)."""
    if x.device.type == "cuda":
        from .split_cuda import split_digits

        e_max = e_max.to(torch.int32).contiguous()
        return split_digits(x, e_max, num_split, b, axis, k_pad), pexp_from_row_exp(e_max)
    if x.device.type == "cpu":
        return split_with_row_exp(x, e_max, num_split, b, axis, k_pad)
    raise ValueError(f"unsupported device {x.device}")


def _split(x: torch.Tensor, num_split: int, b: int, axis: int, k_pad: Optional[int]):
    with span("oz.split"):
        return split_with_exp(x, row_exponent(x, axis), num_split, b, axis, k_pad)


def split_f64(x: torch.Tensor, num_split: int, b: int,
              k_pad: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` [rows, k] into digit planes.

    Returns ``(digits, pexp)``: ``digits`` int8 ``[ns, rows, k]`` (with
    ``k_pad``, ``[ns, rows, k_pad]``, zero beyond k), ``pexp`` int32
    ``[rows]`` with row scale ``2^pexp``; for a batch [B, rows, k],
    ``[ns, B, rows, k or k_pad]`` and ``[B, rows]``.
    """
    return _split(x, num_split, b, 1, k_pad)


def split_f64_cols(x: torch.Tensor, num_split: int, b: int,
                   k_pad: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split ``x`` [k, cols] along columns (for the B operand).

    Same semantics as splitting ``x.T`` row-wise (reference
    split.cu:277-282 swaps m/n and the op), computed directly in the
    [k, cols] layout.  Returns digits int8 ``[ns, k, cols]`` — with
    ``k_pad``, k-major ``[ns, cols, k_pad]``, zero beyond k — and pexp
    int32 [cols]; for a batch [B, k, cols], ``[ns, B, k, cols]`` (or
    ``[ns, B, cols, k_pad]``) and ``[B, cols]``.
    """
    return _split(x, num_split, b, 0, k_pad)
