"""What a metric's reader is given, and the roofline share that several
per-layer readers take.  A per-layer reader returns None where it finds
nothing to read; the harness then leaves its metric out of the result
and says so on standard error."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from . import roofline
from .driver import Driver, Window
from .tracing import Trace


@dataclass
class Measured:
    """What an end-to-end reader is given: the measured window and the
    driver that ran it (its work a unit, its products)."""

    window: Window
    driver: Driver


@dataclass
class Context:
    """The traced run of one cell: its trace of ``units`` units, the engine
    products those units ran, the untraced window before the trace, and the
    median SM clock over that window (None without NVML)."""

    trace: Trace
    units: int
    products: List[roofline.Product]
    window: Window
    clock_mhz: Optional[float]


def roofline_share(ctx: Context, pattern: str,
                   least: Callable[[roofline.Product], float]) -> Optional[float]:
    """Per cent: the least time of the traced products by ``least`` over the
    device time of the kernels whose names match ``pattern``."""
    seconds = ctx.trace.device_seconds(pattern)
    if seconds <= 0 or not ctx.products or any(p.ns is None for p in ctx.products):
        return None
    return 100.0 * sum(least(p) for p in ctx.products) / seconds


#: the engine's int8 products by kernel name: the port's recombine kernel,
#: or an int8 GEMM kernel of a library
ENGINE_KERNELS = r"recombine|imma|i8i8|s8s8|igemm"


def engine_shortfall_pct(ctx: Context, pattern: str = ENGINE_KERNELS) -> float:
    """Per cent of the traced units' engine products that launched no
    kernel whose name matches ``pattern``: 0 where every product ran on the
    engine, 100 where every product fell back to a float64 library GEMM or
    was not routed to the engine at all."""
    if not ctx.products:
        return 0.0
    missing = max(0, len(ctx.products) - ctx.trace.launches(pattern))
    return 100.0 * missing / len(ctx.products)


#: the limit of ``engine_shortfall_pct``: the program reads 0 and a
#: fallback 100; half leaves room for a kernel record that the profiler
#: dropped
ENGINE_SHORTFALL_LIMIT = 50.0
