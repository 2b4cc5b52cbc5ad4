"""Host microseconds a call in the public API (``.call``): operand
normalisation, mode resolution and checks, the self time of the program's
``oz.api`` spans (``core/api.py::gemm``, ``gemm_batched``) less what the
``oz.*`` spans inside them cover, over the traced calls.  Read under the
profiler; None where the program opens no such span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.api")
