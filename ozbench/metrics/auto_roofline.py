"""AUTO's estimator's share of its roofline (``.exprand``): A and B read
once at 8 B an element, at the HBM peak, over the traced units' products,
over the device time of the estimator's kernels (``metrics/auto_ms.py``,
``harness/autoroofline.py``)."""

from harness import autoroofline


def read(ctx):
    seconds = ctx.trace.device_seconds(autoroofline.ESTIMATOR_KERNELS)
    if seconds <= 0 or not ctx.products:
        return None
    return 100.0 * sum(map(autoroofline.estimator_least_s, ctx.products)) / seconds
