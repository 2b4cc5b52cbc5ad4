"""Mantissa-loss estimation and AUTO split-count selection.

Port of ``ozimmu_tpu.ops.mantissa_loss``, a re-derivation of the reference
estimator (src/split.cu:300-518): per element, the mantissa space needed
for an error-free split is ``(group_max_exponent + 1 - exponent) + 53``
bits; with ``ns`` slices of ``b`` bits each, ``loss(ns) = max(0, required -
ns*b)``.  The totals over both operands, averaged per element, drive mode
selection: the smallest ``ns`` whose average loss is within threshold
wins, else the fallback mode (split.cu:453-494).

The JAX package broadcasts ``required`` against all 16 candidates and sums
in int64, which XLA fuses.  Eagerly that would materialise an int32
[16, rows, cols] loss and its int64 copy (~13 GB per operand at 8192^2),
so here ``required`` (an integer in 0..2101) is histogrammed once and
every total follows from the histogram exactly:
``total(ns) = sum_v count[v] * max(0, v - ns*b)``.  Both are exact int64
sums, so the totals equal the JAX package's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.bits import bits64, exponent_field
from ..schedule import bits_per_int8
from ..types import MAX_NUM_SPLIT, MIN_NUM_SPLIT, ComputeMode
from ..utils.log import log

_NS_CANDIDATES = list(range(MIN_NUM_SPLIT, MAX_NUM_SPLIT + 1))
_MANT_MASK = (1 << 52) - 1


def _required_bits(x: torch.Tensor, e_group: torch.Tensor, axis: int) -> torch.Tensor:
    """int32 mantissa space each element of ``x`` needs against the
    scale-group max exponent field ``e_group`` (shape = ``x`` minus
    ``axis``); 0 for elements with value exactly zero and for groups whose
    max exponent field is zero (reference split.cu:322-324)."""
    bcast = (slice(None), None) if axis == 1 else (None, slice(None))
    e = exponent_field(x)
    value_nonzero = (e > 0) | ((bits64(x) & _MANT_MASK) != 0)
    eg = e_group.to(torch.int32)[bcast]
    required = (eg + 1 - e) + 53
    valid = value_nonzero & (eg > 0)
    return torch.where(valid, required, torch.zeros_like(required))


def loss_totals_with_group_exp(
    x: torch.Tensor, e_group: torch.Tensor, b: int, axis: int
) -> torch.Tensor:
    """Loss totals (int64 [16], on ``x``'s device) for ns = 3..18 of ``x``
    against an externally supplied scale-group max exponent field.

    The split between the group maximum and the totals is the JAX
    package's: the distributed estimator supplies a global group maximum
    and sums the partial totals of its shards.  A ``required`` below zero
    (an ``e_group`` below an element's own exponent) loses nothing, as in
    the JAX package, so it is clamped to 0 before the histogram.
    """
    req = _required_bits(x, e_group, axis).clamp_(min=0).reshape(-1)
    counts = torch.bincount(req)  # int64 [max(req) + 1]
    v = torch.arange(counts.numel(), dtype=torch.int64, device=counts.device)
    space = torch.tensor(_NS_CANDIDATES, dtype=torch.int64, device=counts.device) * b
    loss = torch.clamp(v[None, :] - space[:, None], min=0)  # [16, V]
    return (loss * counts[None, :]).sum(dim=1)


def mantissa_loss_totals(x: torch.Tensor, b: int, axis: int = 1) -> torch.Tensor:
    """Loss totals for ns = 3..18 over the scale groups of ``x``.

    ``axis`` is the contraction axis: 1 for A [rows, k] (per-row scale),
    0 for B [k, cols] (per-column scale, in its natural layout).  Returns
    int64 [16] on ``x``'s device.
    """
    e_group = torch.amax(exponent_field(x), dim=axis)
    return loss_totals_with_group_exp(x, e_group, b, axis)


def auto_fallback_mode() -> ComputeMode:
    """The mode AUTO falls back to when even ns=18 exceeds the loss
    threshold.

    The reference falls back to native ``dgemm`` because on a GPU that is
    true hardware f64, more accurate than any rejected int8 mode
    (reference split.cu:473-493, gemm.cu:639-645).  Torch has IEEE f64 on
    every device this package runs on (the CPU and CUDA), so the policy is
    ``ComputeMode.DGEMM`` everywhere.  ``OZIMMU_AUTO_FALLBACK=dgemm|int8_18``
    overrides it (``auto`` = the policy).  The choice is logged.
    """
    raw = os.environ.get("OZIMMU_AUTO_FALLBACK", "auto").lower()
    mode = ComputeMode.FP64_INT8_18 if raw in ("int8_18", "deepest") else ComputeMode.DGEMM
    log(f"AUTO: no split count meets the threshold; falling back to {mode.value} "
        f"(OZIMMU_AUTO_FALLBACK={raw})")
    return mode


def select_mode_from_totals(totals, denom: float, threshold: float) -> ComputeMode:
    """The reference selection loop (split.cu:473-493): smallest ns whose
    AVERAGE loss (``totals[ns] / denom``) is within threshold, else
    :func:`auto_fallback_mode`.  ``totals`` is 16 int64 on the host."""
    totals = np.asarray(totals)
    for idx, ns in enumerate(_NS_CANDIDATES):
        if totals[idx] / denom <= threshold:
            return ComputeMode.from_num_split(ns)
    return auto_fallback_mode()


def complex_loss_totals(a_re, a_im, b_re, b_im, k: int, b_is_cols: bool = True) -> torch.Tensor:
    """ONE shared loss counter over all four re/im planes (reference
    complex estimator semantics, split.cu:69-152 feeding 300-518), with
    per-plane scale groups as this engine splits the planes (see the JAX
    package's docstring for the deviation).  Returns int64 [16]."""
    bb = bits_per_int8(k)
    b_axis = 0 if b_is_cols else 1
    return (
        mantissa_loss_totals(a_re, bb, 1)
        + mantissa_loss_totals(a_im, bb, 1)
        + mantissa_loss_totals(b_re, bb, b_axis)
        + mantissa_loss_totals(b_im, bb, b_axis)
    )


def auto_mode_select_complex(
    a_re, a_im, b_re, b_im, k: int, threshold: float, b_is_cols: bool = True
) -> ComputeMode:
    """Complex AUTO selection from the single shared counter; the average
    divides by the number of real plane elements, ``2 * (m*k + k*n)``."""
    totals = complex_loss_totals(a_re, a_im, b_re, b_im, k, b_is_cols).cpu().numpy()
    m = a_re.shape[0]
    n = b_re.shape[1] if b_is_cols else b_re.shape[0]
    return select_mode_from_totals(totals, 2.0 * (m * k + k * n), threshold)


def auto_mode_select(
    a: torch.Tensor, b_mat: torch.Tensor, k: int, threshold: float, b_is_cols: bool = True
) -> ComputeMode:
    """Pick the smallest adequate split count, else the fallback mode.

    ``a`` is [m, k]; ``b_mat`` is [k, n] when ``b_is_cols`` (split along
    columns), else [n, k] — matching reference split.cu:464-471.  The 16
    totals come to the host once.
    """
    bb = bits_per_int8(k)
    la = mantissa_loss_totals(a, bb, axis=1)
    lb = mantissa_loss_totals(b_mat, bb, axis=0 if b_is_cols else 1)
    totals = (la + lb).cpu().numpy()
    m = a.shape[0]
    n = b_mat.shape[1] if b_is_cols else b_mat.shape[0]
    return select_mode_from_totals(totals, float(m * k + k * n), threshold)
