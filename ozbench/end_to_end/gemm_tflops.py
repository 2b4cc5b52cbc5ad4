"""Effective FP64 TFLOPS: the FP64 operations of every unit completed in
the window (2·m·n·k a matrix) over the window's seconds, CUDA events
before the first unit and after the last.  ``gemm_tflops.batched`` is
the same arithmetic in the batched cell."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.window.units, ctx.driver.work(), ctx.window.seconds) / 1e12
