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
kernel, CPU tensors through the plain version.  So do
:func:`group_totals_into` (the kernel's totals mode: the int32 group
totals of one k panel, stored or added in place, as the streamed
distributed variants sum them) and :func:`fold_totals` (the totals-fold
kernel), whose plain versions are :func:`group_totals` summed and
:func:`fold_group_totals`.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ..schedule import group_schedule
from ..utils.profiling import span
from . import tf32x3

Triple = tf32x3.Triple


#: the recombine kernel's TMA strides are multiples of 16 bytes: the
#: engine's k-major planes are zero-padded along k to this
K_ALIGN = 16


def padded_k(k: int) -> int:
    """``k`` rounded up to :data:`K_ALIGN`: the length of a k-major plane row."""
    return -(-k // K_ALIGN) * K_ALIGN


def acc_shift(num_split: int, b: int) -> int:
    """Exponent bias of the accumulation space (see module docstring)."""
    return b * (num_split + 1) - 64


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [m, k] @ int8 [k, n] -> int32 through ``torch._int_mm``;
    a batch [B, m, k] @ [B, k, n] matrix by matrix.

    On CUDA that op needs m > 16 and k, n multiples of 8; zero padding to
    those sizes is exact (zero digits add zero products), so the operands
    are padded and the result sliced back.
    """
    if a.dim() == 3:
        return torch.stack([_int_mm(x, y) for x, y in zip(a, b)])
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def group_totals(da: torch.Tensor, db: torch.Tensor, num_split: int, k: int, b: int,
                 b_kmajor: bool = False) -> List[torch.Tensor]:
    """Int32 partial products of every scheduled t-group (a list, in
    ascending-t schedule order): the sum of ``da[i-1] @ db[j-1]`` over the
    group's pairs, for planes [ns, m, k] @ [ns, k, n] or, matrix by matrix,
    a batch [ns, B, m, k] @ [ns, B, k, n].  With ``b_kmajor`` B's planes
    come k-major, [ns, (B,) n, k] (the engine's, with A's and B's k both
    zero-padded alike: zero digits add zero products).  Exact — the
    schedule's cap bounds the FULL contraction (pass the true k)."""
    if b_kmajor:
        db = db.transpose(-1, -2)
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
    16-bit-half terms).  Elementwise: a batch's totals fold as each
    matrix's would."""
    shift = acc_shift(num_split, b)
    acc = tf32x3.zeros(totals[0].shape, device=totals[0].device)
    for g, d in zip(group_schedule(num_split, k, b), totals):
        w = g.weight_log2(b) + shift  # in [-62, ...]
        hi = d >> 16  # arithmetic: [-2^15, 2^15)
        lo = d - (hi << 16)  # [0, 2^16)
        acc = tf32x3.add_term(acc, hi.to(torch.float32) * 2.0 ** (w + 16))
        acc = tf32x3.add_term(acc, lo.to(torch.float32) * 2.0**w)
    return tf32x3.renorm(acc)


def recombine(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
              b_kmajor: bool = False) -> Triple:
    """Weighted recombination of all scheduled slice pairs.

    Returns the triple-f32 accumulator ``S_shifted`` [m, n] (for a batch of
    planes [ns, B, m, k] @ [ns, B, k, n], [B, m, n] in one kernel launch)
    such that the mathematical partial result is::

        sum_{i+j<=ns+1} (A_i @ B_j) * 2^(2 - b(i+j))
            == S_shifted * 2^(-ACC_SHIFT)

    The caller folds ``2^(pa + pb - ACC_SHIFT)`` in the epilogue.
    ``b_kmajor``: the planes come as the engine's split writes them, both
    k-major and zero-padded to :func:`padded_k` (A [ns, (B,) m, k_pad], B
    [ns, (B,) n, k_pad]), and the kernel reads them as they are.
    """
    with span("oz.recombine"):
        if da.device.type == "cuda":
            from .recombine_cuda import recombine as recombine_kernel

            return recombine_kernel(da, db, num_split, b, k, b_kmajor=b_kmajor)
        if da.device.type == "cpu":
            totals = group_totals(da, db, num_split, k, b, b_kmajor)
            return fold_group_totals(totals, num_split, k, b)
        raise ValueError(f"unsupported device {da.device}")


def group_totals_into(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
                      totals: Optional[torch.Tensor] = None,
                      b_kmajor: bool = False) -> torch.Tensor:
    """The int32 group totals of one k panel's planes as ONE tensor
    [G, (B,) m, n] (group g in ascending-t schedule order), written to a
    new tensor, or added to ``totals`` in place (exact: the schedule's cap
    bounds the full contraction, so pass the GLOBAL ``k``) and returned.

    On a CUDA device the recombine kernel's totals mode, one launch; its
    planes must come k-major and padded (``b_kmajor``, as the split writes
    them), or the call raises.  On the CPU the plain :func:`group_totals`,
    stacked or added."""
    if da.device.type == "cuda":
        from .recombine_cuda import group_totals as totals_kernel

        if not b_kmajor:
            raise ValueError("the totals mode reads k-major planes only: B [ns, (B,) n, k_pad]")
        return totals_kernel(da, db, num_split, b, k, totals)
    if da.device.type == "cpu":
        step = group_totals(da, db, num_split, k, b, b_kmajor)
        if totals is None:
            return torch.stack(step)
        for t, d in zip(totals, step):
            t.add_(d)
        return totals
    raise ValueError(f"unsupported device {da.device}")


def fold_totals(totals: torch.Tensor, num_split: int, k: int, b: int) -> Triple:
    """:func:`fold_group_totals` of the totals tensor [G, ...] on its
    device: the totals-fold kernel on a CUDA device (one launch), the
    plain version on the CPU."""
    if totals.device.type == "cuda":
        from .recombine_cuda import fold_totals as fold_kernel

        return fold_kernel(totals, num_split, k, b)
    if totals.device.type == "cpu":
        return fold_group_totals(totals, num_split, k, b)
    raise ValueError(f"unsupported device {totals.device}")


#: the JAX package's name for the dispatching entry
recombine_auto = recombine
