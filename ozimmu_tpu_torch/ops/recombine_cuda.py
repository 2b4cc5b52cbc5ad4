"""Wrapper of the CUDA recombine kernel (csrc/recombine.cu).

Port of the TPU kernel ``ozimmu_tpu/ops/recombine_pallas.py::recombine_pallas``.
Its plain PyTorch version is :func:`.recombine.group_totals` followed by
:func:`.recombine.fold_group_totals`; the two are bitwise equal on all
three f32 planes.  The wrapper takes CUDA tensors only and raises on
anything else — there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native
from ..schedule import group_schedule
from .recombine import acc_shift
from .tf32x3 import Triple

#: kernel launches by :func:`recombine` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0


def _schedule_arrays(num_split: int, k: int, b: int):
    """The group schedule as the C entry takes it: pair offsets, 0-based
    plane pairs and the two exact f32 factors of each group."""
    groups = group_schedule(num_split, k, b)
    shift = acc_shift(num_split, b)
    start = np.cumsum([0] + [len(g.pairs) for g in groups]).astype(np.int32)
    pi = np.array([i - 1 for g in groups for i, _ in g.pairs], dtype=np.int32)
    pj = np.array([j - 1 for g in groups for _, j in g.pairs], dtype=np.int32)
    w = np.array([g.weight_log2(b) + shift for g in groups], dtype=np.int32)
    scale_hi = np.ldexp(1.0, w + 16).astype(np.float32)
    scale_lo = np.ldexp(1.0, w).astype(np.float32)
    return len(groups), start, pi, pj, scale_hi, scale_lo


def recombine(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int) -> Triple:
    """The 2^ACC_SHIFT-scaled triple-f32 accumulator [m, n] of the digit
    planes ``da`` int8 [ns, m, k] and ``db`` int8 [ns, k, n]; ``k`` is the
    true contraction length, which sets the group caps."""
    global LAUNCHES
    if da.device.type != "cuda" or db.device != da.device:
        raise ValueError(
            f"recombine needs CUDA tensors on one device, got {da.device} and {db.device}"
        )
    for name, t in (("da", da), ("db", db)):
        if t.dtype != torch.int8 or t.dim() != 3 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int8 [ns, ., .] tensor, got {t.dtype} {tuple(t.shape)}"
            )
    ns, m, k_in = da.shape
    n = db.shape[2]
    if ns != num_split or db.shape[0] != ns or db.shape[1] != k_in:
        raise ValueError(f"plane shapes {tuple(da.shape)} @ {tuple(db.shape)} do not match ns={num_split}")
    if k_in > k or max(m, n, k) >= 2**31:
        raise ValueError(f"unsupported sizes m={m} n={n} k={k_in} (true k={k})")
    if not 3 <= num_split <= 18 or not 1 <= b <= 7:
        raise ValueError(f"unsupported num_split={num_split}, b={b}")
    out = tuple(torch.empty((m, n), dtype=torch.float32, device=da.device) for _ in range(3))
    if m == 0 or n == 0 or k_in == 0:
        return tuple(o.zero_() for o in out)
    # the kernel reads both operands k-contiguous: B's planes go over as
    # [ns, n, k] (one copy of ns*k*n bytes, small beside the product)
    dbt = db.transpose(1, 2).contiguous()
    n_groups, start, pi, pj, shi, slo = _schedule_arrays(num_split, k, b)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        code = native.lib().oz_recombine(
            da.data_ptr(), dbt.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            m, n, k_in, n_groups, ptr(start), ptr(pi), ptr(pj), ptr(shi), ptr(slo), stream,
        )
    native.check(code, "recombine launch")
    LAUNCHES += 1
    return out
