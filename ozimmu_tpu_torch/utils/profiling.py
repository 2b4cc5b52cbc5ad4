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
"""

from __future__ import annotations

import contextlib
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
