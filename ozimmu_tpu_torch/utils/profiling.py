"""Profiling: phase breakdown + per-call wall-clock timing.

Two mechanisms, mirroring the reference:

  1. :class:`PhaseProfiler` — the analogue of
     ``cutf::debug::time_breakdown::profiler`` embedded in the handle
     (reference src/handle.hpp:16, used at gemm.cu:38-48,312-313,393-407).
     When enabled, the engine runs in *staged* mode (split A / split B /
     recombine / epilogue, each ended by a device synchronisation) so each
     phase can be attributed.  When disabled the profiler is inert.

  2. :func:`culip_timer` — per-call timing printed as
     ``[CULiP Result][<name>-m..n..k..] <ns> [ns]`` gated by
     ``OZIMMU_ENABLE_CULIP_PROFILING`` (reference src/culip.cu:14-50).

For kernel timelines, :func:`device_trace` records a ``torch.profiler``
trace of a block.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch

from .env import env_flag


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a torch device, a device
    string or a tensor); a no-op for the CPU, whose ops run eagerly."""
    if isinstance(device, torch.Tensor):
        device = device.device
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseProfiler:
    """Accumulates per-phase wall-clock time across calls."""

    def __init__(self) -> None:
        self.enabled = False
        self._sums_ns: Dict[str, int] = defaultdict(int)
        self._counts: Dict[str, int] = defaultdict(int)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._sums_ns.clear()
        self._counts.clear()

    @contextlib.contextmanager
    def phase(self, name: str, sync=None) -> Iterator[None]:
        """Time a phase; ``sync`` is an optional device or tensor whose
        queued work the phase waits for before it stops the clock."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        yield
        if sync is not None:
            synchronize(sync)
        self._sums_ns[name] += time.perf_counter_ns() - t0
        self._counts[name] += 1

    def record(self, name: str, ns: int) -> None:
        self._sums_ns[name] += ns
        self._counts[name] += 1

    def result_rows(self) -> List[tuple]:
        total = sum(self._sums_ns.values()) or 1
        return [
            (name, self._counts[name], self._sums_ns[name], self._sums_ns[name] / total)
            for name in sorted(self._sums_ns)
        ]

    def print_result(self, tag: str = "", csv: bool = False) -> None:
        """Print the breakdown (reference handle.cu:254-261)."""
        rows = self.result_rows()
        if csv:
            print("tag,phase,count,total_ns,share")
            for name, count, ns, share in rows:
                print(f"{tag},{name},{count},{ns},{share:.4f}")
        else:
            print(f"# Profile result{f' [{tag}]' if tag else ''}")
            for name, count, ns, share in rows:
                print(
                    f"  {name:24s} count={count:6d} total={ns/1e6:10.3f} ms "
                    f"({share*100:5.1f}%)"
                )


@contextlib.contextmanager
def culip_timer(name: str, sync_fn=None) -> Iterator[None]:
    """Per-call timer gated by OZIMMU_ENABLE_CULIP_PROFILING."""
    if not env_flag("OZIMMU_ENABLE_CULIP_PROFILING", default=False):
        yield
        return
    t0 = time.perf_counter_ns()
    yield
    if sync_fn is not None:
        sync_fn()
    dt = time.perf_counter_ns() - t0
    print(f"[CULiP Result][{name}] {dt} [ns]", flush=True)


#: one-element adds that open a traced window on a GPU, ahead of the
#: traced block.  On an H100 (torch 2.11, CUDA 12.8) torch.profiler drops
#: the kernels of a trace's first launches, more of them the older the
#: process: none at 10 s, 4 at 90 s, 13 at 200 s and every one of a
#: 14-launch call from 240 s on, while their launches stay in the trace;
#: pads of idle time around the block did not help.  With 64 adds and a
#: synchronisation first, the trace kept every kernel of that call at
#: every age to 300 s, in three processes (``tools/torch_trace_drift.py``).
TRACE_OPENING_LAUNCHES = 64


def launches_and_kernels(events, skip: int = 0) -> tuple:
    """(kernel launches, their device kernels) among a Chrome trace's
    events, leaving out the first ``skip`` launches (in issue order) and
    their kernels; a kernel is joined to its launch by correlation id."""
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: float(e["ts"]))[skip:]
    ids = {e.get("args", {}).get("correlation") for e in launches}
    kernels = sum(1 for e in events if e.get("cat") == "kernel"
                  and e.get("args", {}).get("correlation") in ids)
    return len(launches), kernels


def open_trace_window() -> None:
    """Launch :data:`TRACE_OPENING_LAUNCHES` one-element adds on the current
    GPU and wait for them: called first inside a ``torch.profiler`` trace,
    they take the launches whose kernels the trace would drop."""
    x = torch.empty(1, device="cuda")
    for _ in range(TRACE_OPENING_LAUNCHES):
        x.add_(1)
    torch.cuda.synchronize()


class TraceLostError(RuntimeError):
    """A :func:`device_trace` whose trace kept none of the kernels its
    block launched."""


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Record a ``torch.profiler`` trace (host ops, and CUDA kernels where
    a GPU is present) of everything inside the block, and write it into
    ``log_dir`` as one Chrome-trace JSON file (view with Perfetto or
    chrome://tracing) — the deep-analysis complement to
    :class:`PhaseProfiler`.

    ::

        with ozt.device_trace("oz_trace"):
            c = ozt.matmul(a, b, mode="fp64_int8_9")

    Raises :class:`TraceLostError` (a ``RuntimeError``) if the block
    launched CUDA kernels and the trace holds none of those kernels (the
    profiler lost them): an empty device trace is never written silently.  On a GPU the trace
    opens with :func:`open_trace_window` and closes once the device has
    finished the block.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            open_trace_window()
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"ozimmu_trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        launches, kernels = launches_and_kernels(json.load(f).get("traceEvents", []),
                                                 skip=TRACE_OPENING_LAUNCHES if cuda else 0)
    if launches and not kernels:
        raise TraceLostError(
            f"device_trace: {launches} kernel launches in the block but no device "
            f"kernel in the trace ({path}); the profiler cannot trace this GPU"
        )
