"""Host microseconds a call in the recombination's wrapper (``.call``):
schedule arrays, operand checks and the launch, the self time of the
program's ``oz.recombine`` spans (``ops/recombine.py::recombine``) over
the traced calls.  Read under the profiler; None where the program opens
no such span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.recombine")
