"""IEEE-754 float64 fields read through the tensor's int64 view.

The CUDA card and the CPU both have real float64, so operands travel as
``torch.float64`` tensors and every bit-level step reads
``x.view(torch.int64)``.  (The JAX package carries f64 as two uint32 bit
planes, ``ozimmu_tpu.core.f64x.F64X``, because its accelerator has no
f64; nothing of that carriage is needed here.)

:func:`from_f64x_planes` and :func:`to_f64x_planes` convert between the
two carriages, so a test can feed both packages the same bits and compare
their outputs bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MANT_MASK = (1 << 52) - 1
_IMPLICIT = 1 << 52


def bits64(x: torch.Tensor) -> torch.Tensor:
    """The IEEE bit pattern of a float64 tensor as int64 (a view)."""
    if x.dtype != torch.float64:
        raise TypeError(f"expected a float64 tensor, got {x.dtype}")
    return x.view(torch.int64)


def exponent_field(x: torch.Tensor) -> torch.Tensor:
    """Biased 11-bit exponent as int32."""
    return ((bits64(x) >> 52) & 0x7FF).to(torch.int32)


def sign_bit(x: torch.Tensor) -> torch.Tensor:
    """1 where the sign bit is set (negative numbers and -0.0), as int32."""
    return (bits64(x) < 0).to(torch.int32)


def mantissa53(x: torch.Tensor) -> torch.Tensor:
    """The 53-bit significand as int64: the implicit bit is set where the
    exponent field is above 0; exponent-field-0 values keep their raw
    mantissa (reference split.cu:160-162)."""
    bits = bits64(x)
    m = bits & _MANT_MASK
    return torch.where(((bits >> 52) & 0x7FF) > 0, m | _IMPLICIT, m)


def from_f64x_planes(hi: np.ndarray, lo: np.ndarray) -> torch.Tensor:
    """float64 CPU tensor from the JAX package's uint32 (hi, lo) bit planes."""
    hi = np.asarray(hi, dtype=np.uint64)
    lo = np.asarray(lo, dtype=np.uint64)
    bits = np.ascontiguousarray((hi << np.uint64(32)) | lo)
    return torch.from_numpy(bits.view(np.float64))


def to_f64x_planes(x: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX package's uint32 (hi, lo) bit planes of a float64 tensor."""
    bits = bits64(x.detach().cpu().contiguous()).numpy().view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo
