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
  * a default compute mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..types import ComputeMode, ComputeModeLike
from ..utils.env import env_compute_mode, env_float, env_int
from ..utils.log import log
from ..utils.profiling import PhaseProfiler


@dataclasses.dataclass
class Handle:
    device: str = "cuda"
    intercept_threshold_m: int = 1024
    intercept_threshold_n: int = 1024
    intercept_threshold_k: int = 1024
    avg_mantissa_loss_threshold: float = 0.0
    default_mode: Optional[ComputeMode] = None
    profiler: PhaseProfiler = dataclasses.field(default_factory=PhaseProfiler)

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
