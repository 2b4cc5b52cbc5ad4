"""ozimmu_tpu_torch — the Ozaki-scheme FP64 GEMM engine on PyTorch and CUDA.

The port of ``ozimmu_tpu`` (JAX/Pallas) to PyTorch, with the two TPU
kernels rewritten by hand in CUDA C++ for Hopper (``csrc/``).  FP64 GEMM
is emulated by error-free mantissa splitting into 3..18 int8 slices, all
slice-pair int8 products with int32 accumulation, and a deterministic
triple-f32 recombination with one final rounding.

This package imports torch and numpy only, never jax.  Operands are
float64 tensors; CUDA tensors go through the CUDA kernels, CPU tensors
through their plain PyTorch versions, bit for bit the same results.

Quick start::

    import numpy as np, ozimmu_tpu_torch as ozt
    a = np.random.rand(2048, 2048); b = np.random.rand(2048, 2048)
    c = ozt.matmul(a, b, mode="fp64_int8_9")     # on "cuda" by default
    c = ozt.gemm(a, b, mode="fp64_int8_9", device="cpu")

Covered so far: real DGEMM at fp64_int8_3..18 and dgemm, op N/T/C,
alpha/beta/c, column-panel chunking, phase profiling.  AUTO mode, complex
operands, sgemm and batched calls raise ``NotImplementedError``.
"""

from .types import ComputeMode, Operation
from .schedule import bits_per_int8, group_schedule
from .core.api import gemm, matmul
from .core.gemm import gemm_f64
from .core.handle import Handle, create, destroy

__version__ = "0.1.0"

__all__ = [
    "ComputeMode",
    "Operation",
    "bits_per_int8",
    "group_schedule",
    "gemm",
    "matmul",
    "gemm_f64",
    "Handle",
    "create",
    "destroy",
    "__version__",
]
