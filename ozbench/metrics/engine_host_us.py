"""Host microseconds a call in the engine's glue (``.call``): checks,
chunk choice, sub-batches and contiguous operands, the self time of the
program's ``oz.engine`` spans (``core/gemm.py::gemm_f64`` and its batched
and complex forms) less what the ``oz.*`` spans inside them cover, over
the traced calls.  Read under the profiler; None where the program opens
no such span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.engine")
