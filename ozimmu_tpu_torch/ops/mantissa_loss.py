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
so the plain version here (:func:`loss_totals_plain`) histograms
``required`` (an integer in 0..2101) once and every total follows from the
histogram exactly: ``total(ns) = sum_v count[v] * max(0, v - ns*b)``.
Both are exact int64 sums, so the totals equal the JAX package's bit for
bit.  That is the path of CPU tensors.  On the card the kernel of
``mantissa_loss_cuda`` (csrc/mantissa_loss.cu) computes the same totals in
one launch an operand, every operand of a decision adding into one device
buffer, which comes to the host once (:func:`decide`); :data:`PATHS`
counts the decisions by the path that formed their totals.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Optional

import numpy as np
import torch

from ..core.bits import bits64, exponent_field
from ..schedule import bits_per_int8
from ..types import MAX_NUM_SPLIT, MIN_NUM_SPLIT, ComputeMode
from ..utils.log import log
from . import mantissa_loss_cuda

_NS_CANDIDATES = list(range(MIN_NUM_SPLIT, MAX_NUM_SPLIT + 1))
_MANT_MASK = (1 << 52) - 1

#: AUTO decisions since the process started, by the path that formed their
#: totals: ``"kernel"`` (CUDA tensors, csrc/mantissa_loss.cu) or
#: ``"torch"`` (the plain histogram, CPU tensors)
PATHS: Counter = Counter()


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


def loss_totals_plain(
    x: torch.Tensor, e_group: torch.Tensor, b: int, axis: int
) -> torch.Tensor:
    """The plain version of :func:`loss_totals_with_group_exp` on any
    device: the histogram of ``required`` (``torch.bincount``, which on a
    CUDA tensor reads its input's range back to the host first)."""
    req = _required_bits(x, e_group, axis).clamp_(min=0).reshape(-1)
    counts = torch.bincount(req)  # int64 [max(req) + 1]
    v = torch.arange(counts.numel(), dtype=torch.int64, device=counts.device)
    space = torch.tensor(_NS_CANDIDATES, dtype=torch.int64, device=counts.device) * b
    loss = torch.clamp(v[None, :] - space[:, None], min=0)  # [16, V]
    return (loss * counts[None, :]).sum(dim=1)


def loss_totals_with_group_exp(
    x: torch.Tensor, e_group: torch.Tensor, b: int, axis: int
) -> torch.Tensor:
    """Loss totals (int64 [16], on ``x``'s device) for ns = 3..18 of ``x``
    against an externally supplied scale-group max exponent field.

    The split between the group maximum and the totals is the JAX
    package's: the distributed estimator supplies a global group maximum
    and sums the partial totals of its shards.  A ``required`` below zero
    (an ``e_group`` below an element's own exponent) loses nothing, as in
    the JAX package, so it is clamped to 0.  A CUDA tensor takes the
    kernel's totals-only entry, a CPU tensor :func:`loss_totals_plain`.
    """
    if x.device.type == "cuda":
        return mantissa_loss_cuda.loss_totals(
            x, b, axis, e_group=e_group.to(torch.int32).contiguous())
    return loss_totals_plain(x, e_group, b, axis)


def mantissa_loss_totals(x: torch.Tensor, b: int, axis: int = 1,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Loss totals for ns = 3..18 over the scale groups of ``x``.

    ``axis`` is the contraction axis: 1 for A [rows, k] (per-row scale),
    0 for B [k, cols] (per-column scale, in its natural layout).  Returns
    int64 [16] on ``x``'s device, added into ``out`` where it is given.
    A CUDA tensor takes the kernel (one launch, the group maxima found in
    it), a CPU tensor the plain histogram.
    """
    if x.device.type == "cuda":
        return mantissa_loss_cuda.loss_totals(x, b, axis, out=out)
    totals = loss_totals_plain(x, torch.amax(exponent_field(x), dim=axis), b, axis)
    return totals if out is None else out.add_(totals)


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


def decide(totals: torch.Tensor, denom: float, threshold: float) -> ComputeMode:
    """One AUTO decision from the summed totals of its operands: the one
    read-back of the decision (``totals`` to the host), counted in
    :data:`PATHS` by the device that formed them, then
    :func:`select_mode_from_totals`."""
    PATHS["kernel" if totals.device.type == "cuda" else "torch"] += 1
    return select_mode_from_totals(totals.cpu().numpy(), denom, threshold)


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
    totals = mantissa_loss_totals(a_re, bb, 1)
    for x, axis in ((a_im, 1), (b_re, b_axis), (b_im, b_axis)):
        mantissa_loss_totals(x, bb, axis, out=totals)
    return totals


def auto_mode_select_complex(
    a_re, a_im, b_re, b_im, k: int, threshold: float, b_is_cols: bool = True
) -> ComputeMode:
    """Complex AUTO selection from the single shared counter; the average
    divides by the number of real plane elements, ``2 * (m*k + k*n)``."""
    totals = complex_loss_totals(a_re, a_im, b_re, b_im, k, b_is_cols)
    m = a_re.shape[0]
    n = b_re.shape[1] if b_is_cols else b_re.shape[0]
    return decide(totals, 2.0 * (m * k + k * n), threshold)


def auto_mode_select(
    a: torch.Tensor, b_mat: torch.Tensor, k: int, threshold: float, b_is_cols: bool = True
) -> ComputeMode:
    """Pick the smallest adequate split count, else the fallback mode.

    ``a`` is [m, k]; ``b_mat`` is [k, n] when ``b_is_cols`` (split along
    columns), else [n, k] — matching reference split.cu:464-471.  A and B
    add into one buffer, whose 16 totals come to the host once.
    """
    bb = bits_per_int8(k)
    totals = mantissa_loss_totals(a, bb, axis=1)
    mantissa_loss_totals(b_mat, bb, axis=0 if b_is_cols else 1, out=totals)
    m = a.shape[0]
    n = b_mat.shape[1] if b_is_cols else b_mat.shape[0]
    return decide(totals, float(m * k + k * n), threshold)
