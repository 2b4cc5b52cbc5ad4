"""The traced run: a torch.profiler window around some units of a cell's
work, and the reading of its Chrome trace.

The window is the benchmark's own span (``SPAN``), opened after 64 one-
element launches and a synchronisation (on an H100 with torch 2.11 the
profiler drops the kernels of a trace's first launches, the older the
process the more of them; 64 launches first kept every kernel), and
closed after the device has finished.  Device time is that of kernels,
copies and fills that start inside the span.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "ozbench.window"
OPENING_LAUNCHES = 64
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
ATTEMPTS = 3


def _open_window() -> None:
    x = torch.empty(1, device="cuda")
    for _ in range(OPENING_LAUNCHES):
        x.add_(1)
    torch.cuda.synchronize()


def _capture_once(run, cuda, lead):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            _open_window()
        if lead is not None:
            lead()
        with record_function(SPAN):
            out = run()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="ozbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Trace(events), out


def capture(run: Callable[[], object], cuda: bool,
            lead: Optional[Callable[[], object]] = None) -> Tuple["Trace", object]:
    """Run ``run()`` inside a profiler window; return the window's trace and
    what ``run`` returned.  ``lead()`` runs first under the profiler,
    outside the window, and has to end with the device idle: it brings
    the card back to the state of a measured window after the profiler's
    start left it idle.  The Chrome trace passes through one temporary
    file under ``TMPDIR``, removed once read.  A trace that kept no device
    operation in the window lost its device records (seen on an H100 with
    torch 2.11 in a process that had already run profiler sessions) and is
    captured again, up to ``ATTEMPTS`` times in all."""
    for attempt in range(1, ATTEMPTS + 1):
        trace, out = _capture_once(run, cuda, lead)
        if not cuda or trace.device or attempt == ATTEMPTS:
            return trace, out
        print(f"[trace] the profiler kept no device operation in the window (attempt {attempt}); "
              "capturing again", file=sys.stderr)
    raise AssertionError("unreachable")


class Trace:
    """The events of one traced window (times in the trace's microseconds)."""

    def __init__(self, events: List[dict]):
        spans = [e for e in events if e.get("name") == SPAN and e.get("cat") == "user_annotation"
                 and "dur" in e]
        if not spans:
            raise ValueError(f"the trace has no {SPAN!r} span")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""), e["cat"])
            for e in events
            if e.get("cat") in DEVICE_CATS and self.t0 <= float(e["ts"]) <= self.t1
        )
        self.host = [
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
            for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != SPAN and "dur" in e
        ]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            e = min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def idle_share(self) -> Optional[float]:
        """Per cent of the window in which the device runs nothing; None
        where the trace holds no device operation."""
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_seconds(self, pattern: Optional[str] = None, exclude: Optional[str] = None,
                       cats=("kernel",)) -> float:
        """Summed duration of the device operations of ``cats`` whose name
        matches ``pattern`` (all, if None) and not ``exclude``."""
        inc = re.compile(pattern) if pattern else None
        exc = re.compile(exclude) if exclude else None
        return sum(
            (e - s) / 1e6 for s, e, name, cat in self.device
            if cat in cats and (inc is None or inc.search(name))
            and (exc is None or not exc.search(name))
        )

    def launches(self, pattern: str) -> int:
        """Kernels in the window whose name matches ``pattern``."""
        inc = re.compile(pattern)
        return sum(1 for _, _, name, cat in self.device if cat == "kernel" and inc.search(name))

    def device_ops(self) -> List[List]:
        """The device operations that took most time, summed by name."""
        by: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The device's idle time in the window, summed by the innermost
        host operation under way at the start of each gap."""
        edges = [self.t0]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.t1)
        by: Dict[str, float] = {}
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge <= gs:
                continue
            under = [h for h in self.host if h[0] <= gs < h[1]]
            label = min(under, key=lambda h: h[1] - h[0])[2] if under else "(no host op)"
            by[label] = by.get(label, 0.0) + (ge - gs) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
