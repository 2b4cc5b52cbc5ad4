"""Device milliseconds a call in AUTO's estimator (``.exprand``): the
mantissa-loss totals of A and B that choose the mode
(``ops/mantissa_loss.py``, inside the span ``oz.auto``).  The trace keeps
no correlation ids, so the kernels are found by the names torch gives
them (``harness/autoroofline.ESTIMATOR_KERNELS``).  In a traced 8192³
call on an H100 they were 65 launches: ``at::cuda::kernelHistogram1D``
(``torch.bincount``), ``at::native::vectorized_elementwise_kernel`` (the
field's shift and mask, the comparisons, ``where``, ``clamp``),
``at::native::unrolled_elementwise_kernel`` (the casts),
``at::native::elementwise_kernel<128, 2, ...>`` (int32 sums) and
``at::native::reduce_kernel`` (the group max, bincount's min and max,
the totals).  The engine's own torch ops on its scales fall under the
same names and are counted too (about 12 µs a call in a traced 16384³
GEMM).  The launches matched a unit go to stderr."""

import sys

from harness import autoroofline


def read(ctx):
    if not ctx.trace.device:
        return None
    kernels = autoroofline.ESTIMATOR_KERNELS
    print(f"[metric] auto_ms: {ctx.trace.launches(kernels) / ctx.units!r} launches a unit",
          file=sys.stderr)
    return 1e3 * ctx.trace.device_seconds(kernels) / ctx.units
