"""The card: the look for it, its description in the result, and its SM
clock and power read through NVML while a window runs."""

from __future__ import annotations

import ctypes
import statistics
import sys
import threading
from typing import List, Optional

import torch

NVML_CLOCK_SM = 1


class NoDevice(RuntimeError):
    """Fewer CUDA devices than the cell asks for."""


def require_cuda(chips: int) -> torch.device:
    """The first CUDA device, or :class:`NoDevice`: a run never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
    return torch.device("cuda", 0)


def describe(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": chips,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


class Nvml:
    """The few NVML readings the harness takes, through ctypes; every
    reading is None where NVML or the reading is missing."""

    def __init__(self, device: torch.device):
        self._lib = self._handle = None
        if device.type != "cuda":
            return
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        if lib.nvmlInit_v2() != 0:
            return
        handle = ctypes.c_void_p()
        index = torch.cuda._get_nvml_device_index(device)
        if lib.nvmlDeviceGetHandleByIndex_v2(ctypes.c_uint(index), ctypes.byref(handle)) != 0:
            return
        self._lib, self._handle = lib, handle

    def _uint(self, fn: str, *args) -> Optional[int]:
        if self._lib is None:
            return None
        v = ctypes.c_uint()
        if getattr(self._lib, fn)(self._handle, *args, ctypes.byref(v)) != 0:
            return None
        return v.value

    def sm_clock_mhz(self) -> Optional[int]:
        return self._uint("nvmlDeviceGetClockInfo", ctypes.c_int(NVML_CLOCK_SM))

    def power_w(self) -> Optional[float]:
        mw = self._uint("nvmlDeviceGetPowerUsage")
        return None if mw is None else mw / 1e3

    def power_limit_w(self) -> Optional[float]:
        mw = self._uint("nvmlDeviceGetEnforcedPowerLimit")
        return None if mw is None else mw / 1e3


class Sampler:
    """SM clock and power draw sampled every ``period`` seconds on a thread
    between :meth:`start` and :meth:`stop`."""

    def __init__(self, nvml: Nvml, period: float = 0.2):
        self.nvml, self.period = nvml, period
        self.clocks: List[int] = []
        self.watts: List[float] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.wait(self.period):
            c, w = self.nvml.sm_clock_mhz(), self.nvml.power_w()
            if c is not None:
                self.clocks.append(c)
            if w is not None:
                self.watts.append(w)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()

    def median_clock(self) -> Optional[float]:
        return float(statistics.median(self.clocks)) if self.clocks else None

    def report(self) -> None:
        """One line on stderr: the card's limit, median clock and mean draw."""
        limit = self.nvml.power_limit_w()
        watts = statistics.fmean(self.watts) if self.watts else None
        print(f"[device] power.limit={limit} W, window: median SM clock {self.median_clock()} MHz, "
              f"mean draw {watts} W over {len(self.watts)} samples", file=sys.stderr)
