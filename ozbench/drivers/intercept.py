"""``torch.matmul`` inside ``ozimmu_tpu_torch.intercept`` on ``pairs``
operand pairs in turn, each call synchronised before the next, as a
caller that reads every product: a closed loop timed call by call.

Traffic keys: ``m``, ``n``, ``k``, ``pairs``, ``kept_calls`` (calls kept
for the reference, drawn from the seed among the first ``kept_from``),
``soak_s``, ``trace_units``, ``trace_lead_s``, ``sample_entries``."""

import os
import time
from typing import Dict

import torch

from harness import driver, spec

gemm = spec.load("drivers", "gemm", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Driver(gemm.Driver):
    _ctx = None

    def prepare(self) -> None:
        tr = self.tr
        self.batch = 0
        self.pairs = int(tr["pairs"])
        g = self.generator()
        self.a_all = self.operand((self.pairs, tr["m"], tr["k"]), g)
        self.b_all = self.operand((self.pairs, tr["k"], tr["n"]), g)
        self._ctx = self.ozt.intercept.intercept(mode=self.mode)
        self._ctx.__enter__()
        self.run_units(self.pairs)

    def release(self) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None

    def unit(self, i: int):
        p = i % self.pairs
        return torch.matmul(self.a_all[p], self.b_all[p])

    def finish(self, out) -> None:
        driver.sync(self.device)

    def window(self, seconds: float) -> driver.Window:
        """Closed loop: each call issued, then synchronised; latency from
        the call to the return of the synchronise.  Keeps the outputs of
        ``kept_calls`` calls drawn from the seed among the first
        ``kept_from``, and of the last."""
        keep = set(int(v) for v in self.rng.choice(int(self.tr["kept_from"]),
                                                   int(self.tr["kept_calls"]), replace=False))
        win = driver.Window()
        driver.sync(self.device)
        first = None
        while True:
            i = win.units
            t0 = time.perf_counter()
            out = self.unit(i)
            t1 = time.perf_counter()
            self.finish(out)
            t2 = time.perf_counter()
            first = t0 if first is None else first
            win.latency_s.append(t2 - t0)
            win.issue_s.append(t1 - t0)
            win.units += 1
            if i in keep:
                win.kept.append((i, out))
            if t2 - first >= seconds:
                break
        win.seconds = t2 - first
        if not win.kept or win.kept[-1][0] != i:
            win.kept.append((i, out))
        return win

    def judge(self, i: int, out) -> Dict[str, float]:
        p = i % self.pairs
        return self.reference().numbers(self.a_all[p], self.b_all[p], out,
                                        int(self.tr["sample_entries"]), self.seed + i)

    def control(self) -> Dict[str, float]:
        ref = self.reference()
        a, b = self.a_all[0], self.b_all[0]
        return ref.numbers(a, b, ref.control(a, b), int(self.tr["sample_entries"]), self.seed)
