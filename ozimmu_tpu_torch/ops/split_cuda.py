"""Wrapper of the CUDA split kernel (csrc/split.cu).

Port of the TPU kernel ``ozimmu_tpu/ops/split_pallas.py::split_digits_pallas``.
Its plain PyTorch version is :func:`.split.split_with_row_exp`; the two are
bitwise equal.  The wrapper takes CUDA tensors only and raises on anything
else — there is no fallback.
"""

from __future__ import annotations

import torch

from .. import native

#: kernel launches by :func:`split_digits` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0


def split_digits(
    x: torch.Tensor, e_max: torch.Tensor, num_split: int, b: int, axis: int = 1
) -> torch.Tensor:
    """Digit planes int8 [ns, R, C] of the float64 matrix ``x`` [R, C]
    against ``e_max`` (int32 [R] for axis=1, [C] for axis=0)."""
    global LAUNCHES
    if x.device.type != "cuda" or e_max.device != x.device:
        raise ValueError(
            f"split_digits needs CUDA tensors on one device, got {x.device} and {e_max.device}"
        )
    if x.dtype != torch.float64 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"split_digits needs a contiguous 2-D float64 tensor, got {x.dtype} {tuple(x.shape)}"
        )
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    rows, cols = x.shape
    if e_max.dtype != torch.int32 or tuple(e_max.shape) != (x.shape[1 - axis],) or not e_max.is_contiguous():
        raise ValueError(
            f"e_max must be contiguous int32 [{x.shape[1 - axis]}], got {e_max.dtype} {tuple(e_max.shape)}"
        )
    if not (1 <= b <= 7 and 1 <= num_split and num_split * b <= 126):
        raise ValueError(f"unsupported num_split={num_split}, b={b} (needs ns*b <= 126, b <= 7)")
    out = torch.empty((num_split, rows, cols), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = native.lib().oz_split_digits(
            x.data_ptr(), e_max.data_ptr(), out.data_ptr(),
            rows, cols, num_split, b, axis, stream,
        )
    native.check(code, "split_digits launch")
    LAUNCHES += 1
    return out
