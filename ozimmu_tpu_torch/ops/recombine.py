"""Recombination: slice-pair int8 products + exact extended accumulation.

Replaces the reference's per-pair loop (src/gemm.cu:385-403: one int8 GEMM
and one f64 accumulate kernel per pair) with the structure of
``ozimmu_tpu.ops.recombine``:

  1. Pairs sharing ``t = i + j`` have the same recombination weight
     ``2^(2 - b t)``, so their partial products are summed in int32
     (the schedule's group cap guarantees no overflow,
     schedule.group_schedule).
  2. Each group's int32 total is split exactly into two f32 terms
     (high/low 16-bit halves) and folded into a triple-float32
     accumulator (~71-bit) in ascending-t order — deterministic, and
     strictly more accurate than the reference's per-step f64 rounding
     (gemm.cu:77-102).

Scaling: accumulation happens in a ``2^ACC_SHIFT``-biased space.
``ACC_SHIFT = b*(ns+1) - 64`` puts the smallest group weight at exactly
2^-62 and the largest possible head magnitude at ``2^(b(ns-1) - 31) <=
2^88``, so every f32 component stays in the normal range.  The shift is
kept exactly as the JAX package has it: bitwise parity depends on it.

:func:`group_totals` + :func:`fold_group_totals` are the plain PyTorch
version of the CUDA kernel in :mod:`.recombine_cuda`.  :func:`recombine`
picks by the operands' device alone: CUDA tensors always go through the
kernel, CPU tensors through the plain version.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..schedule import group_schedule
from . import tf32x3

Triple = tf32x3.Triple


def acc_shift(num_split: int, b: int) -> int:
    """Exponent bias of the accumulation space (see module docstring)."""
    return b * (num_split + 1) - 64


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] @ int8 [k, n] -> int32 through ``torch._int_mm``.

    On CUDA that op needs m > 16 and k, n multiples of 8; zero padding to
    those sizes is exact (zero digits add zero products), so the operands
    are padded and the result sliced back.
    """
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def group_totals(da: torch.Tensor, db: torch.Tensor, num_split: int, k: int, b: int) -> List[torch.Tensor]:
    """Int32 partial products of every scheduled t-group (a list, in
    ascending-t schedule order): the sum of ``da[i-1] @ db[j-1]`` over the
    group's pairs.  Exact — the schedule's cap bounds the FULL contraction
    (pass the true k)."""
    totals = []
    for g in group_schedule(num_split, k, b):
        d = None
        for i, j in g.pairs:
            p = _int_mm(da[i - 1], db[j - 1])
            d = p if d is None else d + p
        totals.append(d)
    return totals


def fold_group_totals(totals, num_split: int, k: int, b: int) -> Triple:
    """Deterministic fold of the int32 group totals into the triple-f32
    accumulator (ascending t; each total split exactly into two f32
    16-bit-half terms)."""
    shift = acc_shift(num_split, b)
    acc = tf32x3.zeros(totals[0].shape, device=totals[0].device)
    for g, d in zip(group_schedule(num_split, k, b), totals):
        w = g.weight_log2(b) + shift  # in [-62, ...]
        hi = d >> 16  # arithmetic: [-2^15, 2^15)
        lo = d - (hi << 16)  # [0, 2^16)
        acc = tf32x3.add_term(acc, hi.to(torch.float32) * 2.0 ** (w + 16))
        acc = tf32x3.add_term(acc, lo.to(torch.float32) * 2.0**w)
    return tf32x3.renorm(acc)


def recombine(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int) -> Triple:
    """Weighted recombination of all scheduled slice pairs.

    Returns the triple-f32 accumulator ``S_shifted`` [m, n] such that the
    mathematical partial result is::

        sum_{i+j<=ns+1} (A_i @ B_j) * 2^(2 - b(i+j))
            == S_shifted * 2^(-ACC_SHIFT)

    The caller folds ``2^(pa + pb - ACC_SHIFT)`` in the epilogue.
    """
    if da.device.type == "cuda":
        from .recombine_cuda import recombine as recombine_kernel

        return recombine_kernel(da, db, num_split, b, k)
    if da.device.type == "cpu":
        return fold_group_totals(group_totals(da, db, num_split, k, b), num_split, k, b)
    raise ValueError(f"unsupported device {da.device}")


#: the JAX package's name for the dispatching entry
recombine_auto = recombine
