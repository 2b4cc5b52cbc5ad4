"""Wrapper of the CUDA split kernel (csrc/split.cu).

Port of the TPU kernel ``ozimmu_tpu/ops/split_pallas.py::split_digits_pallas``.
Its plain PyTorch version is :func:`.split.split_with_row_exp`; the two are
bitwise equal.  The wrapper takes CUDA tensors only and raises on anything
else — there is no fallback.

:func:`split_plan` decides everything about a launch that depends on the
shape (layout, elements per thread, 16-byte loads, grid, shared memory) in
plain Python, so that the CPU tests can check it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import native

#: kernel launches by :func:`split_digits` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0

#: threads of a block (csrc/split.cu, THREADS)
THREADS = 256
#: the tiles kernel's tile: TILE k rows x TILE columns
TILE = 64
#: 32-bit words of one column of a tile in shared memory: TILE k bytes and
#: one word of padding (csrc/split.cu, TILE_WORDS)
TILE_WORDS = TILE // 4 + 1
#: elements per thread (and bytes per plane store) of the rows kernel where
#: the output row length allows it
VEC = 16
#: blocks of a grid-stride kernel per SM (split and exponent rows kernels)
BLOCKS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    layout: str  # "rows" (csrc split_rows_kernel) or "tiles" (split_tiles_kernel)
    vec: int  # elements per thread of a row (rows), bytes per 16-byte store (tiles)
    load16: bool  # 16-byte loads of two elements
    out_cols: int  # length of a plane's row: cols, or the padded k
    grid: int
    threads: int
    smem_bytes: int


def split_plan(batch: int, rows: int, cols: int, axis: int, num_split: int,
               k_pad: Optional[int], aligned16: bool, sms: int) -> SplitPlan:
    """The launch that splits ``batch`` matrices [rows, cols] along ``axis``
    on a card with ``sms`` SMs.  ``k_pad`` None writes the natural layout
    [ns, batch, rows, cols]; a multiple of 16 at least k writes the k-major
    form recombine reads: [ns, batch, rows, k_pad] for A (``axis=1``, k =
    cols) and, through shared-memory tiles, [ns, batch, cols, k_pad] for B
    (``axis=0``, k = rows).  ``aligned16``: the operand's base address is
    16-byte aligned and its batch and row strides are even (in elements)."""
    k = cols if axis == 1 else rows
    if k_pad is not None and (k_pad % 16 or k_pad < k):
        raise ValueError(f"k_pad={k_pad} is not a multiple of 16 at least k={k}")
    if min(batch, rows, cols, sms) < 1:
        raise ValueError(f"no split launch for {batch} x [{rows}, {cols}] on {sms} SMs")
    if k_pad is not None and axis == 0:
        grid = batch * math.ceil(cols / TILE) * math.ceil(k_pad / TILE)
        plan = SplitPlan(layout="tiles", vec=16, load16=aligned16, out_cols=k_pad, grid=grid,
                         threads=THREADS, smem_bytes=num_split * TILE * TILE_WORDS * 4)
    else:
        out_cols = cols if k_pad is None else k_pad
        vec = VEC if out_cols % VEC == 0 else 1
        chunks = batch * rows * (out_cols // vec)
        plan = SplitPlan(layout="rows", vec=vec, load16=aligned16 and vec > 1,
                         out_cols=out_cols, grid=min(math.ceil(chunks / THREADS),
                                                     sms * BLOCKS_PER_SM),
                         threads=THREADS, smem_bytes=0)
    if plan.grid >= 2**31:
        raise ValueError(f"{plan.grid} blocks exceed the kernel's 32-bit grid")
    return plan


def _strides(x: torch.Tensor):
    """(batch stride, row stride) in elements of a [B, R, C] or [R, C]
    float64 tensor whose rows are contiguous; raises otherwise."""
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"the rows of x must be contiguous, got strides {x.stride()}")
    sr = x.stride(-2) if x.shape[-2] > 1 else x.shape[-1]
    sb = x.stride(0) if x.dim() == 3 else x.shape[-2] * sr
    return sb, sr


def _aligned16(x: torch.Tensor, *strides: int) -> bool:
    return x.data_ptr() % 16 == 0 and all(s % 2 == 0 for s in strides)


def split_digits(
    x: torch.Tensor, e_max: torch.Tensor, num_split: int, b: int, axis: int = 1,
    k_pad: Optional[int] = None,
) -> torch.Tensor:
    """Digit planes int8 [ns, R, C] of the float64 matrix ``x`` [R, C]
    against ``e_max`` (int32 [R] for axis=1, [C] for axis=0); or, in one
    launch, int8 [ns, B, R, C] of a batch ``x`` [B, R, C] against ``e_max``
    [B, R] or [B, C], each matrix against its own exponents.

    ``k_pad`` (a multiple of 16, at least k) writes the k-major form that
    recombine reads, zero beyond k: [ns, (B,) R, k_pad] for A (axis=1) and
    [ns, (B,) C, k_pad] for B (axis=0).  ``x`` is read through its strides
    (its rows must be contiguous), so a column panel is split where it
    lies."""
    global LAUNCHES
    if x.device.type != "cuda" or e_max.device != x.device:
        raise ValueError(
            f"split_digits needs CUDA tensors on one device, got {x.device} and {e_max.device}"
        )
    if x.dtype != torch.float64 or x.dim() not in (2, 3):
        raise ValueError(
            f"split_digits needs a 2-D or 3-D float64 tensor, got {x.dtype} {tuple(x.shape)}"
        )
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    e_shape = (*x.shape[:-2], x.shape[-1 - axis])
    if e_max.dtype != torch.int32 or tuple(e_max.shape) != e_shape or not e_max.is_contiguous():
        raise ValueError(
            f"e_max must be contiguous int32 {list(e_shape)}, got {e_max.dtype} {tuple(e_max.shape)}"
        )
    if not (1 <= b <= 7 and 1 <= num_split and num_split * b <= 126 and num_split <= 18):
        raise ValueError(
            f"unsupported num_split={num_split}, b={b} (needs ns*b <= 126, ns <= 18, b <= 7)")
    sb, sr = _strides(x)
    batch = x.shape[0] if x.dim() == 3 else 1
    rows, cols = x.shape[-2:]
    if k_pad is None:
        out_shape = (num_split, *x.shape)
    else:
        out_shape = (num_split, *x.shape[:-2], rows if axis == 1 else cols, k_pad)
    out = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    if out.numel() == 0 or x.numel() == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = split_plan(batch, rows, cols, axis, num_split, k_pad, _aligned16(x, sb, sr), sms)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = native.lib().oz_split_digits(
            x.data_ptr(), e_max.data_ptr(), out.data_ptr(), batch, rows, cols, sb, sr,
            plan.out_cols, num_split, b, axis, int(plan.layout == "tiles"), plan.vec,
            int(plan.load16), plan.grid, plan.smem_bytes, stream,
        )
    native.check(code, "split_digits launch")
    LAUNCHES += 1
    native.counted(__name__, "LAUNCHES")
    return out
