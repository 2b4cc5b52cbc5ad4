"""Host microseconds a call in the epilogue's wrapper (``.call``):
exponents, checks and the launch, the self time of the program's
``oz.epilogue`` spans (``core/gemm.py::_epilogue_SE``) over the traced
calls.  Read under the profiler; None where the program opens no such
span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.epilogue")
