"""Wrapper of the CUDA mantissa-loss kernel (csrc/mantissa_loss.cu).

AUTO's estimator on the card: the 16 loss totals of an operand for ns =
3..18, added into one int64 [16] buffer on the device, so that a decision
reads its totals back once.  It replaces no TPU kernel (the JAX package's
estimator is plain XLA); its plain PyTorch version is
:func:`.mantissa_loss.loss_totals_plain`, and the two are equal bit for
bit.  The wrapper takes CUDA tensors only and raises on anything else —
there is no fallback.  :func:`loss_plan` decides the launch in plain
Python, so that the CPU tests can check it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import native
from .split_cuda import _aligned16, _strides

#: kernel launches by :func:`loss_totals` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0

#: threads of a block (csrc/mantissa_loss.cu, THREADS)
THREADS = 256
#: 32-bit words of shared memory a thread keeps fields in (two a word),
#: at most: 64 KiB a block
STAGE_WORDS = 64
#: a row's pairs of elements a thread takes, at most, before a row gets
#: more warps (rows kernel, up to a whole block)
ROW_WORDS = 16
#: blocks of the rows kernel's grid-stride loop per SM
ROW_BLOCKS_PER_SM = 8
#: columns of a strip (cols kernel): 32 bytes of a row, a sector
STRIP = 4
#: the most elements a thread may sum: its 32-bit sums of min(r, ns*b)
#: gain at most 126 an element
MAX_THREAD_ELEMENTS = (2**32 - 1) // 126


@dataclasses.dataclass(frozen=True)
class LossPlan:
    width: int  # warps of a row (axis 1), columns of a strip (axis 0)
    staged: int  # words of shared memory a thread keeps fields in
    load16: bool  # 16-byte loads of two elements
    grid: int
    threads: int
    smem_bytes: int


def loss_plan(batch: int, rows: int, cols: int, axis: int, aligned16: bool, sms: int,
              external: bool = False) -> LossPlan:
    """The launch that sums the losses of ``batch`` matrices [rows, cols]
    by rows (``axis=1``: a row on 1 to 8 warps, enough that a thread takes
    at most :data:`ROW_WORDS` pairs of it) or by columns (``axis=0``: a
    strip of :data:`STRIP` columns over all rows), on a card with ``sms``
    SMs.  ``external``: the group maxima
    are given, so nothing is kept for a second pass."""
    if min(batch, rows, cols, sms) < 1:
        raise ValueError(f"no mantissa-loss launch for {batch} x [{rows}, {cols}] on {sms} SMs")
    if axis == 1:
        pairs = math.ceil(cols / 2)
        width = 1
        while width < THREADS // 32 and math.ceil(pairs / (32 * width)) > ROW_WORDS:
            width *= 2
        words = math.ceil(pairs / (32 * width))
        rounds = math.ceil(batch * rows / (THREADS // (32 * width)))
        grid = min(rounds, sms * ROW_BLOCKS_PER_SM)
        per_thread = 2 * words * math.ceil(rounds / grid)
    else:
        # two columns a thread, so THREADS / (STRIP / 2) rows a step
        width = STRIP
        words = math.ceil(rows / (THREADS // (STRIP // 2)))
        grid = batch * math.ceil(cols / STRIP)
        per_thread = 2 * words
    staged = 0 if external else min(words, STAGE_WORDS)
    if grid >= 2**31:
        raise ValueError(f"{grid} blocks exceed the kernel's 32-bit grid")
    if per_thread > MAX_THREAD_ELEMENTS:
        raise ValueError(f"{per_thread} elements a thread would overflow its 32-bit sums")
    return LossPlan(width=width, staged=staged, load16=aligned16, grid=grid, threads=THREADS,
                    smem_bytes=staged * THREADS * 4)


def _readable(x: torch.Tensor, axis: int):
    """``x`` and ``axis`` in a layout the kernel reads (rows contiguous): a
    transposed matrix is read as its transpose along the other axis; any
    other layout is copied."""
    if x.shape[-1] <= 1 or x.stride(-1) == 1:
        return x, axis
    if x.dim() == 2 and (x.shape[0] <= 1 or x.stride(0) == 1):
        return x.t(), 1 - axis
    return x.contiguous(), axis


def loss_totals(x: torch.Tensor, b: int, axis: int = 1, e_group: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the 16 mantissa-loss totals (ns = 3..18, ``b`` bits a slice) of
    the float64 matrix ``x`` [R, C], or of each matrix of a batch [B, R, C],
    grouped along its contraction axis (``axis=1``: by rows; ``axis=0``: by
    columns) into ``out`` (int64 [16] on ``x``'s device), or into a new
    buffer, zeroed in the launch, when ``out`` is None.  Returns the buffer.

    ``e_group`` (int32, contiguous: [R] or [B, R] for ``axis=1``, [C] or
    [B, C] for ``axis=0``) gives the groups' maximum exponent fields, as
    the distributed estimator does; without it the kernel finds them.
    One launch; nothing is read back."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"mantissa_loss_cuda.loss_totals needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float64 or x.dim() not in (2, 3):
        raise ValueError(f"mantissa_loss_cuda.loss_totals needs a 2-D or 3-D float64 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if not 0 <= b <= 7:
        raise ValueError(f"b must be 0..7 bits a slice, got {b}")
    if out is not None and (out.dtype != torch.int64 or tuple(out.shape) != (16,)
                            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int64 [16] on {x.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if e_group is not None:
        e_shape = (*x.shape[:-2], x.shape[-1 - axis])
        if (e_group.dtype != torch.int32 or tuple(e_group.shape) != e_shape
                or e_group.device != x.device or not e_group.is_contiguous()):
            raise ValueError(f"e_group must be a contiguous int32 {list(e_shape)} on {x.device}, "
                             f"got {e_group.dtype} {tuple(e_group.shape)} on {e_group.device}")
    x, axis = _readable(x, axis)
    zero = out is None
    if zero:
        out = torch.empty(16, dtype=torch.int64, device=x.device)
    batch = x.shape[0] if x.dim() == 3 else 1
    rows, cols = x.shape[-2:]
    if x.numel() == 0:  # nothing to add: the call only zeroes a new buffer
        sb = sr = 0
        plan = LossPlan(width=0, staged=0, load16=False, grid=0, threads=THREADS, smem_bytes=0)
    else:
        sb, sr = _strides(x)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = loss_plan(batch, rows, cols, axis, _aligned16(x, sb, sr), sms,
                         external=e_group is not None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = native.lib().oz_mantissa_loss(
            x.data_ptr(), None if e_group is None else e_group.data_ptr(), out.data_ptr(),
            int(zero), batch, rows, cols, sb, sr, axis, b, plan.width, plan.staged,
            int(plan.load16), plan.grid, plan.smem_bytes, stream,
        )
    native.check(code, "mantissa_loss launch")
    if plan.grid:
        LAUNCHES += 1
        native.counted(__name__, "LAUNCHES")
    return out
