"""``ozimmu_tpu_torch.gemm`` on complex128 [m, k] @ [k, n] with complex
``alpha``, ``beta`` and ``c``: C = alpha·A·B + beta·C0, the same A, B and
C0 every call (``gemm`` returns a new tensor, so C0 stays as made), back
to back on one stream with at most ``inflight`` calls queued, as the
``gemm`` driver runs its products.

Traffic keys: those of the ``gemm`` driver but ``batch``, and ``alpha``
and ``beta`` as (re, im) pairs.  A unit stands for 8·m·n·k FP64
operations (ozIMMU's count of a ZGEMM: four real products) and runs four
real engine passes over the four parts' shared splits."""

import os
from typing import Dict, List

from harness import roofline, spec

gemm = spec.load("drivers", "gemm", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the real passes of one complex product: re·re, im·im, re·im, im·re
PASSES = 4


class Driver(gemm.Driver):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha, self.beta = complex(*self.tr["alpha"]), complex(*self.tr["beta"])

    def prepare(self) -> None:
        tr = self.tr
        g = self.generator()
        self.a = self.operand((tr["m"], tr["k"]), g)
        self.b = self.operand((tr["k"], tr["n"]), g)
        self.c0 = self.operand((tr["m"], tr["n"]), g)
        self.run_units(1)

    def unit(self, i: int):
        return self.ozt.gemm(self.a, self.b, alpha=self.alpha, beta=self.beta, c=self.c0,
                             mode=self.mode)

    def products(self) -> List[roofline.Product]:
        tr = self.tr
        return [roofline.Product(1, tr["m"], tr["n"], tr["k"], self.ns, beta=self.beta != 0)
                for _ in range(PASSES)]

    def work(self) -> float:
        return sum(roofline.fp64_flops(p) for p in self.products())

    def _numbers(self, out, seed: int) -> Dict[str, float]:
        return self.reference().numbers(self.a, self.b, self.c0, self.alpha, self.beta, out,
                                        int(self.tr["sample_entries"]), seed)

    def judge(self, i: int, out) -> Dict[str, float]:
        return self._numbers(out, self.seed + i)

    def control(self) -> Dict[str, float]:
        ref = self.reference()
        return self._numbers(ref.control(self.a, self.b, self.c0, self.alpha, self.beta),
                             self.seed)
