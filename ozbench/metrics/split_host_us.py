"""Host microseconds a call in the split's wrappers, both operands
(``.call``): the exponent and split kernels' launches and the torch ops
around them, the self time of the program's ``oz.split`` spans
(``ops/split.py``) over the traced calls.  Read under the profiler; None
where the program opens no such span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.split")
