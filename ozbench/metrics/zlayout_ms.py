"""Device milliseconds a unit in the complex layout (``.complex``): the
copies that make contiguous float64 planes of the complex operands and
the interleave of the result's planes (``core/api.py``'s ``_planes`` and
``_complex_result``, inside the ``oz.zlayout`` span, counted by
``ZLAYOUT_COPIES``).  The trace keeps no correlation ids, so the kernels
are found by the names torch gives them: its copy kernel and its kernel
of ``torch.complex``.  The launches matched a unit go to stderr, to be
held against ``ZLAYOUT_COPIES`` a call."""

import sys

KERNELS = r"direct_copy_kernel_cuda|complex_kernel_cuda"


def read(ctx):
    if not ctx.trace.device:
        return None
    print(f"[metric] zlayout_ms: {ctx.trace.launches(KERNELS) / ctx.units!r} launches a unit",
          file=sys.stderr)
    return 1e3 * ctx.trace.device_seconds(KERNELS) / ctx.units
