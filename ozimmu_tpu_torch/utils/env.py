"""Environment-variable configuration (reference src/utils.hpp:77-96).

Keeps the reference's variable names so existing deployment recipes port
unchanged (reference README.md:54-77):

  OZIMMU_COMPUTE_MODE                       default compute mode (read per
                                            call by the interceptor, as in
                                            cublas.cu:18-48)
  OZIMMU_INFO / OZIMMU_ERROR                logging gates (utils.hpp:98-115)
  OZIMMU_ENABLE_CULIP_PROFILING             per-call timing (culip.cu:11-12)
  OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD   auto-mode threshold
                                            (cublas.cu:72-83)
  OZIMMU_INTERCEPT_THRESHOLD_M/N/K          interception gates, default 1024
                                            (handle.cu:25-30)
"""

from __future__ import annotations

import os
from typing import Callable, Optional


def load_env_if_defined(name: str, default: str = "") -> str:
    v = os.environ.get(name)
    return v if v is not None else default


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v != "0"


def run_if_env_defined(name: str, func: Callable[[], None], default: bool = False) -> None:
    if env_flag(name, default):
        func()


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def env_compute_mode() -> Optional[str]:
    """OZIMMU_COMPUTE_MODE, or None when unset/empty."""
    v = os.environ.get("OZIMMU_COMPUTE_MODE")
    return v if v else None
