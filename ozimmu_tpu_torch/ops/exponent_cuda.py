"""Wrapper of the CUDA exponent-max kernel (csrc/exponent.cu).

Replaces ``ozimmu_tpu/ops/split.py::row_exponent`` (plain XLA in the JAX
package).  Its plain PyTorch version is :func:`.split.row_exponent_plain`;
the two are equal.  The wrapper takes CUDA tensors only and raises on
anything else — there is no fallback.  :func:`exponent_plan` decides the
launch in plain Python, so that the CPU tests can check it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import native
from .split_cuda import BLOCKS_PER_SM, THREADS, _aligned16, _strides

#: kernel launches by :func:`exponent_max` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0

#: rows of one block of the columns kernel
SLAB = 256


@dataclasses.dataclass(frozen=True)
class ExponentPlan:
    load16: bool  # 16-byte loads of two elements
    strip: int  # columns of a block (axis=0); 0 for rows
    slab: int  # rows of a block (axis=0); 0 for rows
    grid: int
    threads: int


def exponent_plan(batch: int, rows: int, cols: int, axis: int, aligned16: bool,
                  sms: int) -> ExponentPlan:
    """The launch that reduces ``batch`` matrices [rows, cols] along
    ``axis`` on a card with ``sms`` SMs: one warp per row (``axis=1``,
    grid-stride), or one block per strip of columns and slab of
    :data:`SLAB` rows (``axis=0``)."""
    if min(batch, rows, cols, sms) < 1:
        raise ValueError(f"no exponent launch for {batch} x [{rows}, {cols}] on {sms} SMs")
    if axis == 1:
        warps = THREADS // 32
        plan = ExponentPlan(load16=aligned16, strip=0, slab=0, threads=THREADS,
                            grid=min(math.ceil(batch * rows / warps), sms * BLOCKS_PER_SM))
    else:
        strip = 64 if aligned16 else 32
        plan = ExponentPlan(load16=aligned16, strip=strip, slab=SLAB, threads=THREADS,
                            grid=batch * math.ceil(cols / strip) * math.ceil(rows / SLAB))
    if plan.grid >= 2**31:
        raise ValueError(f"{plan.grid} blocks exceed the kernel's 32-bit grid")
    return plan


def exponent_max(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """int32 max of the biased exponent field of the float64 matrix ``x``
    [R, C] along its contraction axis: [R] (``axis=1``) or [C] (``axis=0``);
    for a batch [B, R, C], [B, R] or [B, C], in one launch.  ``x`` is read
    through its strides (its rows must be contiguous)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"exponent_max needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float64 or x.dim() not in (2, 3):
        raise ValueError(
            f"exponent_max needs a 2-D or 3-D float64 tensor, got {x.dtype} {tuple(x.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if x.shape[-2 + axis] == 0:
        raise ValueError(f"exponent_max over an empty axis {axis} of {tuple(x.shape)}")
    sb, sr = _strides(x)
    batch = x.shape[0] if x.dim() == 3 else 1
    rows, cols = x.shape[-2:]
    out = torch.empty((*x.shape[:-2], rows if axis == 1 else cols), dtype=torch.int32,
                      device=x.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = exponent_plan(batch, rows, cols, axis, _aligned16(x, sb, sr), sms)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = native.lib().oz_exponent_max(
            x.data_ptr(), out.data_ptr(), batch, rows, cols, sb, sr, axis, int(plan.load16),
            plan.grid, plan.slab, stream,
        )
    native.check(code, "exponent_max launch")
    LAUNCHES += 1
    native.counted(__name__, "LAUNCHES")
    return out
