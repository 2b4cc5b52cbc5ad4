"""Device milliseconds a solve in the libraries' operations that the
complex solver calls besides the copies (``.zhpl``): cuSOLVER's panels,
cuBLAS's triangular solves, the row swaps' index kernels and the pivots'
read-back.  It is ``panel_ms``'s time with ``zcopy_ms``'s copies left
out, so the two metrics share no operation."""

import os

from harness import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_KERNELS = spec.load("metrics", "panel_ms", HERE).PORT_KERNELS
COPY_NAMES = spec.load("metrics", "zcopy_ms", HERE).NAMES


def read(ctx):
    if not ctx.trace.device:
        return None
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    exclude = f"{PORT_KERNELS}|{COPY_NAMES}"
    return 1e3 * ctx.trace.device_seconds(exclude=exclude, cats=cats) / ctx.units
