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

Covered: real and complex GEMM (``gemm``, ``matmul``, ``gemm_batched``,
``gemm_f64``, ``zgemm_f64``) at fp64_int8_3..18, AUTO mode selection
(``fp64_int8_auto``, also what an unset mode resolves to;
``auto_mode_select``), the dgemm and sgemm modes, op N/T/C, alpha/beta/c,
column-panel chunking, phase profiling, ``device_trace``, ``warmup`` and
``reallocate_working_memory``; drop-in interception of float64 and
complex128 matmuls (``intercept``: a dispatch mode over aten
mm/bmm/addmm/baddbmm), the ``torch.compile`` surface (``traced``: custom
ops), the bench CLI (``python -m ozimmu_tpu_torch.bench_cli``) with its
timing helpers (``testing``) and the long-double oracle (``oracle``, built
with g++ at first use); the HPL-class solvers (``linalg``: blocked LU and
Cholesky on the host or resident on the device, real and complex, ``solve``
with iterative refinement) and ``bench_cli hpl``; the distributed layer
(``parallel``: SUMMA, k-sharded, Cannon ring and streamed SUMMA, AUTO and
pre-sharded entries on ``torch.distributed``, with the CUDA kernels in
every rank).  The modules ``hostref`` (the numpy model of the engine,
independent of torch, that the kernels are held against), ``schedule``,
``testing`` and ``types`` are exported as the JAX package exports them.
Runnable examples: ``examples/torch_0*.py``.
"""

from .types import (
    ComputeMode,
    ElementKind,
    Operation,
    INT8_MODES,
    MAX_NUM_SPLIT,
    MIN_NUM_SPLIT,
    get_compute_mode_name_str,
)
from .schedule import bits_per_int8, group_schedule, pair_schedule
from .core.api import auto_mode_select, gemm, gemm_batched, matmul, warmup
from .core.gemm import gemm_f64, zgemm_f64
from .core.handle import (
    Handle,
    create,
    destroy,
    default_handle,
    enable_profiling,
    disable_profiling,
    print_profiler_result,
    clear_profiler_result,
    reallocate_working_memory,
    set_auto_mantissa_loss_threshold,
    get_auto_mantissa_loss_threshold,
)
from .utils.profiling import device_trace
from . import hostref, intercept, linalg, parallel, schedule, testing, traced, types

__version__ = "0.1.0"

__all__ = [
    "ComputeMode",
    "ElementKind",
    "Operation",
    "INT8_MODES",
    "MIN_NUM_SPLIT",
    "MAX_NUM_SPLIT",
    "bits_per_int8",
    "pair_schedule",
    "group_schedule",
    "gemm",
    "gemm_batched",
    "matmul",
    "warmup",
    "gemm_f64",
    "zgemm_f64",
    "auto_mode_select",
    "get_compute_mode_name_str",
    "Handle",
    "create",
    "destroy",
    "default_handle",
    "enable_profiling",
    "device_trace",
    "hostref",
    "intercept",
    "linalg",
    "parallel",
    "schedule",
    "testing",
    "traced",
    "types",
    "disable_profiling",
    "print_profiler_result",
    "clear_profiler_result",
    "reallocate_working_memory",
    "set_auto_mantissa_loss_threshold",
    "get_auto_mantissa_loss_threshold",
    "__version__",
]
