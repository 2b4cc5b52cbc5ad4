"""HPL's rate: (2/3·N³ + 3/2·N²) for every solve completed in the window,
over the window's seconds (CUDA events)."""

from harness import stats


def read(ctx):
    return stats.rate(ctx.window.units, ctx.driver.work(), ctx.window.seconds) / 1e9
