"""The program's own spans in a traced window, and the arithmetic of the
per-layer metrics that read them.

``ozimmu_tpu_torch`` opens a host span named ``oz.<layer>`` at each layer
edge while a profiler is active (``utils/profiling.span``): they are
``Trace.host`` events like the torch ops, on the clock of the device's
operations.  Everything here reads those events clipped to the window, and
``Trace.busy()``; a trace without ``oz.*`` spans (a program that opens
none) reads None, never zero.  The spans of one window are taken to come
from one host thread, as the benchmark's drivers issue every call from
one."""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Iterable, List, Optional, Tuple

PREFIX = "oz."

Span = Tuple[float, float, str]


def spans(trace) -> List[Span]:
    """The ``oz.*`` host spans that overlap the window, clipped to it, by
    start (the longer first where two start together)."""
    out = []
    for s, e, name in trace.host:
        if name.startswith(PREFIX) and s < trace.t1 and e > trace.t0:
            out.append((max(s, trace.t0), min(e, trace.t1), name))
    return sorted(out, key=lambda x: (x[0], x[0] - x[1]))


def _covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def self_us(trace, name: str) -> Optional[float]:
    """Summed self time, in the trace's microseconds, of the spans named
    ``name`` in the window: each one's duration less what the ``oz.*``
    spans inside it cover.  None where the window has no such span."""
    sp = spans(trace)
    starts = [s for s, _, _ in sp]
    total, found = 0.0, False
    for i, (s, e, n) in enumerate(sp):
        if n != name:
            continue
        found = True
        inner = [(cs, ce) for j in range(bisect_left(starts, s), bisect_right(starts, e))
                 if j != i for cs, ce, _ in (sp[j],) if ce <= e]
        total += (e - s) - _covered(inner)
    return total if found else None


def self_us_per_unit(ctx, name: str) -> Optional[float]:
    """:func:`self_us` of ``name`` over the traced units."""
    us = self_us(ctx.trace, name)
    return None if us is None else us / ctx.units


def gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle intervals in the window: between ``Trace.busy()``'s
    intervals, and before the first and after the last."""
    edges = [trace.t0]
    for s, e in trace.busy():
        edges += [s, e]
    edges.append(trace.t1)
    return [(gs, ge) for gs, ge in zip(edges[0::2], edges[1::2]) if ge > gs]


def _under(t: float, sp: List[Span]) -> bool:
    return any(s <= t < e for s, e, _ in sp)


def idle_under_us(trace, within: Tuple[str, ...], outside: Tuple[str, ...] = ()) -> Optional[float]:
    """Summed length, in the trace's microseconds, of the idle gaps that
    open while the host is inside a span named in ``within`` and inside
    none named in ``outside``.  None where the window has no span of
    ``within``."""
    sp = spans(trace)
    inside = [x for x in sp if x[2] in within]
    if not inside:
        return None
    excluded = [x for x in sp if x[2] in outside]
    return sum(ge - gs for gs, ge in gaps(trace)
               if _under(gs, inside) and not _under(gs, excluded))
