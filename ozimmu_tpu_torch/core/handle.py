"""Engine handle: configuration, device and profiler.

API-parity layer for the reference handle (include/ozimmu/ozimmu.hpp:47-73,
src/handle.cu), ported from ``ozimmu_tpu.core.handle``.  PyTorch's caching
allocator and current stream take the place of the reference's arena and
stream, so the handle keeps:

  * the device that numpy inputs are placed on (default ``"cuda"``);
  * interception thresholds (env ``OZIMMU_INTERCEPT_THRESHOLD_{M,N,K}``,
    default 1024 — reference handle.cu:25-30);
  * the auto-mode average-mantissa-loss threshold (default 0.0 —
    reference handle.hpp:26, env at cublas.cu:72-83);
  * the phase profiler (reference handle.hpp:16);
  * a default compute mode;
  * an advisory working-memory floor (``working_memory_bytes``).

``reallocate_working_memory(handle, gemm_list)`` keeps its reference
meaning "make these GEMM shapes cheap to launch": it warms each listed
shape up (kernel build plus one run) and returns the largest estimated
working set in bytes (reference handle.cu:95-144 semantics).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..schedule import working_set_bytes
from ..types import ComputeMode, ComputeModeLike, ElementKind, Operation
from ..utils.env import env_compute_mode, env_float, env_int
from ..utils.log import log
from ..utils.profiling import PhaseProfiler

#: (op_a, op_b, m, n, k, element_kind, compute_mode) — reference
#: ``gemm_params_t`` (ozimmu.hpp:62-66).
GemmParams = Tuple[Operation, Operation, int, int, int, ElementKind, ComputeMode]
GemmList = List[GemmParams]


@dataclasses.dataclass
class Handle:
    device: str = "cuda"
    intercept_threshold_m: int = 1024
    intercept_threshold_n: int = 1024
    intercept_threshold_k: int = 1024
    avg_mantissa_loss_threshold: float = 0.0
    default_mode: Optional[ComputeMode] = None
    profiler: PhaseProfiler = dataclasses.field(default_factory=PhaseProfiler)
    #: advisory working-memory floor set by the bytes overload of
    #: reallocate_working_memory (reference handle.cu:63-93).  PyTorch's
    #: caching allocator owns real allocation; this records the caller's
    #: reservation intent and is grow-only, like the reference arena.
    working_memory_bytes: int = 0

    def resolve_mode(self, mode: Optional[ComputeModeLike]) -> ComputeMode:
        """Explicit arg > handle default > env OZIMMU_COMPUTE_MODE > auto."""
        if mode is not None:
            return ComputeMode.parse(mode)
        if self.default_mode is not None:
            return self.default_mode
        env = env_compute_mode()
        if env is not None:
            return ComputeMode.parse(env)
        return ComputeMode.FP64_INT8_AUTO


_global_handle: Optional[Handle] = None


def create(device: str = "cuda") -> Handle:
    """Create a handle with env-derived defaults (reference handle.cu:6-33)."""
    log("Initializing ozIMMU handle")
    return Handle(
        device=device,
        intercept_threshold_m=env_int("OZIMMU_INTERCEPT_THRESHOLD_M", 1024),
        intercept_threshold_n=env_int("OZIMMU_INTERCEPT_THRESHOLD_N", 1024),
        intercept_threshold_k=env_int("OZIMMU_INTERCEPT_THRESHOLD_K", 1024),
        avg_mantissa_loss_threshold=env_float(
            "OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD", 0.0
        ),
    )


def destroy(handle: Handle) -> int:
    """Parity no-op (PyTorch owns all device state) — reference handle.cu:35-52."""
    log("Destroying ozIMMU handle")
    handle.profiler.clear()
    return 0


def default_handle() -> Handle:
    global _global_handle
    if _global_handle is None:
        _global_handle = create()
    return _global_handle


def enable_profiling(handle: Handle) -> None:
    handle.profiler.enable()


def disable_profiling(handle: Handle) -> None:
    handle.profiler.disable()


def print_profiler_result(handle: Handle, tag: str = "", csv: bool = False) -> None:
    handle.profiler.print_result(tag, csv)


def clear_profiler_result(handle: Handle) -> None:
    handle.profiler.clear()


def set_auto_mantissa_loss_threshold(handle: Handle, threshold: float) -> None:
    handle.avg_mantissa_loss_threshold = float(threshold)


def get_auto_mantissa_loss_threshold(handle: Handle) -> float:
    return handle.avg_mantissa_loss_threshold


def reallocate_working_memory(handle: Handle, gemm_list) -> int:
    """Warm the listed GEMMs up; return their largest estimated working
    set in bytes.

    The reference grows a device arena to the max working set
    (handle.cu:95-144); PyTorch's caching allocator allocates per call, so
    the actionable equivalent is :func:`~ozimmu_tpu_torch.core.api.warmup`
    of each (shape, kind, mode): the kernel build and a first run, whose
    blocks the allocator then keeps.

    Bytes overload (reference handle.cu:63-93): passing an ``int`` grows
    the handle's advisory reservation instead, grow-only (the reference's
    no-op-when-smaller behaviour), and returns the current reservation.
    """
    from . import api  # local import to avoid a cycle

    if isinstance(gemm_list, int):
        size = int(gemm_list)
        if size > handle.working_memory_bytes:
            handle.working_memory_bytes = size
            log(f"Reallocated working memory advisory to {size} B")
        else:
            log(
                f"Working memory advisory kept at {handle.working_memory_bytes} B"
                f" (requested {size} B; grow-only, reference handle.cu:68-72)"
            )
        return handle.working_memory_bytes

    max_bytes = 0
    for _op_a, _op_b, m, n, k, kind, mode in gemm_list:
        mode = ComputeMode.parse(mode)
        kind = ElementKind(kind)
        if mode.is_int8:
            max_bytes = max(
                max_bytes,
                working_set_bytes(m, n, k, mode.num_split, complex_=kind is ElementKind.COMPLEX),
            )
        api.warmup(m, n, k, mode, kind, handle=handle)
    log(f"Warmed up for working set of {max_bytes} B")
    return max_bytes
