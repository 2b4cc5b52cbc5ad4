"""Device-idle milliseconds a call that AUTO's host work causes
(``.exprand``): the idle gaps of the traced window that open while the
host is inside the program's ``oz.auto`` span (the estimator's launches
and its reads of sizes and totals back to the host), over the traced
calls.  None where the program opens no such span."""

from harness import spans


def read(ctx):
    us = spans.idle_under_us(ctx.trace, ("oz.auto",))
    return None if us is None else us / 1e3 / ctx.units
