"""Host microseconds a call in the interceptor's own code (``.call``):
its gate, the operands made plain and the routing, the self time of the
program's ``oz.intercept`` spans (``intercept``'s ``__torch_dispatch__``)
less what the ``oz.*`` spans inside them cover, over the traced calls.
Read under the profiler, which slows host code; None where the program
opens no such span."""

from harness import spans


def read(ctx):
    return spans.self_us_per_unit(ctx, "oz.intercept")
