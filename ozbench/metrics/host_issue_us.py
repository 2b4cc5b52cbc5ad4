"""Mean host microseconds from entering ``torch.matmul`` under the
interceptor to its return, before the synchronise (``.call``): the
benchmark's own span around each call of the traced run's untraced
window."""

import statistics


def read(ctx):
    if not ctx.window.issue_s:
        return None
    return statistics.fmean(ctx.window.issue_s) * 1e6
