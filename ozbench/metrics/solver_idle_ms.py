"""Device-idle milliseconds a solve that the solver's own host work
causes (``.hpl``): the idle gaps of the traced window that open while the
host is inside the program's ``oz.lu_factor`` or ``oz.lu_solve`` span and
inside no ``oz.engine`` span (the panels, the pivots' read-back, the row
swaps, the glue of each step), over the traced solves.  None where the
program opens no solver span."""

from harness import spans


def read(ctx):
    us = spans.idle_under_us(ctx.trace, ("oz.lu_factor", "oz.lu_solve"), ("oz.engine",))
    return None if us is None else us / 1e3 / ctx.units
