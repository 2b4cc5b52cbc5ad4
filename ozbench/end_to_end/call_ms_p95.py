"""The nearest-rank 95th percentile, over every call of the window, of one
call's latency on the host clock: from issuing the call to the return of
the synchronise that makes its result readable."""

from harness import stats


def read(ctx):
    return stats.percentile(ctx.window.latency_s, 95) * 1e3
