"""HPL's solve in complex128, as the ``hpl`` driver runs the real one:
``linalg.lu_factor`` of the pristine complex A (the port copies A itself)
with the configuration's ``NB`` and ``panel``, then ``linalg.lu_solve``
of A x = b; solve after solve, back to back.

A solve stands for 4 · (2/3·N³ + 3/2·N²) FP64 operations (ozIMMU's ×4,
as a ZGEMM counts under ``gemm_tflops``), and its engine products are the
real LU's, each run as four real passes over shared splits.  The program
counts its factorization steps by dtype and panel kind
(``linalg.LU_STEPS``): after the warm solve ``prepare`` checks that it
ran ⌈N/NB⌉ steps of ("complex128", <panel>), and raises otherwise; a
program without the counter is not checked.  Each solve run outside the
measured window (the warm one, the traced one) prints its steps and its
complex layout copies (``core.gemm.ZLAYOUT_COPIES``) on stderr, and on a
CUDA device the warm solve's peak of allocated memory, A and b included.

Traffic keys: those of the ``hpl`` driver."""

import os
import sys
from collections import Counter
from typing import List

import torch

from harness import roofline, spec

hpl = spec.load("drivers", "hpl", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the real passes of one complex product: re·re, im·im, re·im, im·re
PASSES = 4


class Driver(hpl.Driver):
    def prepare(self) -> None:
        linalg = getattr(self.ozt, "linalg", None)
        self.steps = getattr(linalg, "LU_STEPS", None)
        engine = getattr(getattr(self.ozt, "core", None), "gemm", None)
        self.layout = engine if hasattr(engine, "ZLAYOUT_COPIES") else None
        g = self.generator()
        n = int(self.cfg["N"])
        self.a = self.operand((n, n), g)
        self.b = self.operand((n,), g)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.run_units(1)
        if cuda:
            print(f"[zhpl] peak allocated in the warm solve, A and b included: "
                  f"{torch.cuda.max_memory_allocated(self.device)!r} B", file=sys.stderr)
        if self.ran is not None:
            want = {("complex128", self.cfg["panel"]): -(-n // int(self.cfg["NB"]))}
            if self.ran != want:
                raise RuntimeError(f"the warm solve ran the factorization steps {self.ran}, "
                                   f"not {want}: the cell's solve is not the resident complex LU")

    def run_units(self, n: int):
        """``n`` solves as the window runs them; the last output.  The
        factorization steps and layout copies a solve go to stderr, and
        the steps of the ``n`` solves are kept in ``ran`` (None without
        the program's counter)."""
        before = Counter(self.steps) if self.steps is not None else None
        copies = self.layout.ZLAYOUT_COPIES if self.layout is not None else None
        out = super().run_units(n)
        ran = None
        if before is not None:
            ran = dict(Counter(self.steps) - before)
            print(f"[zhpl] factorization steps a solve: "
                  f"{ {k: v / n for k, v in ran.items()} }", file=sys.stderr)
        if copies is not None:
            print(f"[zhpl] complex layout copies a solve: "
                  f"{(self.layout.ZLAYOUT_COPIES - copies) / n!r}", file=sys.stderr)
        self.ran = ran
        return out

    def products(self) -> List[roofline.Product]:
        return [p for p in super().products() for _ in range(PASSES)]

    def work(self) -> float:
        return PASSES * super().work()
