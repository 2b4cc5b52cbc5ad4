"""The base of the traffic mixes' drivers, and the measured window.

A traffic file names its driver (``"driver"``), which is the file
``ozbench/drivers/<driver>.py`` and its class ``Driver``, and gives the
driver's parameters; the configuration gives the mode, the operands (each
kind the file ``ozbench/operands/<kind>.py``) and the reference.  A
driver makes the cell's inputs on the device from the seed, warms up the
cell's own shapes, soaks the card with the cell's own calls, runs the
measured window and hands the kept outputs to the reference.  What this
base gives every driver: the seed's generators, the operands by kind, the
back-to-back window with CUDA events, and the soak.
"""

from __future__ import annotations

import collections
import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import roofline, spec


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What a measured window did."""

    units: int = 0
    seconds: float = 0.0
    kept: List[Tuple[int, object]] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    issue_s: List[float] = field(default_factory=list)
    #: back-to-back drivers on a card: each unit's device seconds, from
    #: the end of the one before
    unit_s: List[float] = field(default_factory=list)


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device, program,
                 bench_dir: str = spec.BENCH_DIR):
        self.cfg, self.tr, self.device, self.ozt = config, traffic, device, program
        self.bench_dir = bench_dir
        self.seed = int(seed) % 2**63
        self.mode = config["mode"]
        self.ns = roofline.num_split(self.mode)
        self.rng = np.random.default_rng([self.seed, 0xC0FFEE])

    def generator(self) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        return g

    def operand(self, shape, g: torch.Generator) -> torch.Tensor:
        """The configuration's operands of ``shape``, made on the device by
        ``operands/<kind>.py``."""
        return spec.load("operands", self.cfg["operands"], self.bench_dir).make(
            tuple(shape), g, self.device)

    # -- to be given by each driver ------------------------------------
    def prepare(self) -> None:
        """Inputs from the seed, and one warm call of every shape used."""
        raise NotImplementedError

    def unit(self, i: int):
        """Issue unit ``i`` of the work; return its output."""
        raise NotImplementedError

    def work(self) -> float:
        """The FP64 operations that one unit stands for."""
        raise NotImplementedError

    def products(self) -> List[roofline.Product]:
        """The engine products of one unit (``ns`` None where the mode
        fixes no number of slices)."""
        raise NotImplementedError

    def judge(self, i: int, out) -> Dict[str, float]:
        """The reference's numbers for the output of unit ``i``."""
        raise NotImplementedError

    def control(self) -> Dict[str, float]:
        """The numbers of the control, put in the program's place."""
        raise NotImplementedError

    # -- shared ----------------------------------------------------------
    def release(self) -> None:
        """Leave the program's context before the reference runs."""

    def soak(self, seconds: float) -> int:
        """The cell's own units, run as the window runs them, for
        ``seconds``: the card reaches its power cap before the window opens."""
        return self.window(seconds).units if seconds > 0 else 0

    def reference(self):
        return importlib.import_module(f"reference.{self.cfg['reference']}")

    def finish(self, out) -> None:
        """What the caller does with each output before the next call;
        back-to-back drivers issue ahead and do nothing."""

    def run_units(self, n: int):
        """``n`` units as the window runs them; the last output."""
        out = None
        for i in range(n):
            out = self.unit(i)
            self.finish(out)
        sync(self.device)
        return out

    def window(self, seconds: float) -> Window:
        """Units back to back, at most ``inflight`` queued, until the host
        clock passes ``seconds``; timed by CUDA events from before the first
        to after the last.  Keeps the output of the first unit issued after
        a seed-drawn point of the window, and of the last."""
        inflight = int(self.tr.get("inflight", 1))
        keep_at = seconds * float(self.rng.uniform(0.25, 0.75))
        cuda = self.device.type == "cuda"
        win = Window()
        queue: collections.deque = collections.deque()
        marks = []
        sync(self.device)
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = None
        while True:
            out = self.unit(win.units)
            win.units += 1
            if not win.kept and time.perf_counter() - t0 >= keep_at:
                win.kept.append((win.units - 1, out))
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                queue.append(ev)
                marks.append(ev)
                if len(queue) >= inflight:
                    queue.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            end.record()
            end.synchronize()
            win.seconds = start.elapsed_time(end) / 1e3
            edges = [start, *marks]
            win.unit_s = [a.elapsed_time(b) / 1e3 for a, b in zip(edges, edges[1:])]
        else:
            win.seconds = time.perf_counter() - t0
        if not win.kept or win.kept[-1][0] != win.units - 1:
            win.kept.append((win.units - 1, out))
        return win


def make(config: dict, traffic: dict, seed: int, device: torch.device, program,
         bench_dir: str = spec.BENCH_DIR) -> Driver:
    """The driver that the traffic names, from ``drivers/<driver>.py``."""
    cls = spec.load("drivers", traffic["driver"], bench_dir).Driver
    return cls(config, traffic, seed, device, program, bench_dir)
