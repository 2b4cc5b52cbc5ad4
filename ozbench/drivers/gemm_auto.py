"""``ozimmu_tpu_torch.gemm`` on [m, k] @ [k, n] in ``fp64_int8_auto``: each
call estimates the mantissa loss of A and B, chooses the number of slices
and runs it, on the same operands every call, back to back on one stream
with at most ``inflight`` calls queued, as the ``gemm`` driver runs its
products (AUTO reads its totals back to the host, so a call waits there
for the one before it).

The configuration's ``auto_threshold`` is set on a handle of the driver's
own (``set_auto_mantissa_loss_threshold``).  The program counts each
AUTO decision by the chosen mode (``core.gemm.AUTO_CHOICES``): the mode
of the warm call gives ``ns``, so that the rooflines count the chosen
mode's work, and every decision of the run is held against the plain AUTO
rule (``reference/auto.py``) as ``auto_mode_err``, beside the GEMM's
numbers.  A program without that counter cannot be judged, so
``prepare`` refuses it before any work.

Traffic keys: those of the ``gemm`` driver but ``batch``."""

import importlib
import os
import sys
from collections import Counter
from typing import Dict

from harness import roofline, spec

gemm = spec.load("drivers", "gemm", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Driver(gemm.Driver):
    def prepare(self) -> None:
        engine = getattr(getattr(self.ozt, "core", None), "gemm", None)
        self.choices = getattr(engine, "AUTO_CHOICES", None)
        if self.choices is None:
            raise RuntimeError(
                "this program does not count its AUTO decisions (no core.gemm.AUTO_CHOICES): "
                "the cell cannot tell which mode AUTO chose, so it does not run")
        self.before = Counter(self.choices)
        self.handle = self.ozt.create(device=str(self.device))
        self.ozt.set_auto_mantissa_loss_threshold(self.handle, float(self.cfg["auto_threshold"]))
        self.batch = 0
        g = self.generator()
        self.a = self.operand((self.tr["m"], self.tr["k"]), g)
        self.b = self.operand((self.tr["k"], self.tr["n"]), g)
        self.run_units(1)
        chosen = self.decisions()
        self.ns = roofline.num_split(chosen.most_common(1)[0][0]) if chosen else None
        self.want = None

    def unit(self, i: int):
        return self.ozt.gemm(self.a, self.b, mode=self.mode, handle=self.handle)

    def decisions(self) -> Counter:
        """The AUTO decisions since ``prepare`` began, by mode."""
        return Counter(self.choices) - self.before

    def mode_err(self, chosen: Counter) -> float:
        """The share of ``chosen`` that is not the reference rule's mode,
        worked out once a run (its averages go to stderr)."""
        ref = importlib.import_module("reference.auto")
        if self.want is None:
            threshold = float(self.cfg["auto_threshold"])
            avg = ref.averages(self.a, self.b)
            self.want = ref.choose(avg, threshold)
            shown = [ns for ns in avg if avg[ns] < 1][:4]
            print(f"[auto] the rule's average bits lost an element: "
                  f"{', '.join(f'ns {ns} {avg[ns]!r}' for ns in shown)}; "
                  f"threshold {threshold!r}; its mode {self.want}; the program's decisions "
                  f"{dict(self.decisions())}", file=sys.stderr)
        return ref.mode_err(chosen, self.want)

    def judge(self, i: int, out) -> Dict[str, float]:
        return {**super().judge(i, out), "auto_mode_err": self.mode_err(self.decisions())}

    def control(self) -> Dict[str, float]:
        """The float32 product in the program's place; it makes no AUTO
        decision, so its ``auto_mode_err`` is 1."""
        return {**super().control(), "auto_mode_err": self.mode_err(Counter())}
