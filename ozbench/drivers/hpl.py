"""HPL's solve: ``linalg.lu_factor`` of the pristine A (the port copies A
itself) with the configuration's ``NB`` and ``panel``, then
``linalg.lu_solve`` of A x = b; solve after solve, back to back.

Traffic keys: ``soak_s``, ``trace_units``, ``trace_lead_s``; the sizes
are the configuration's (``N``, ``NB``)."""

from typing import Dict, List

from harness import driver, roofline


class Driver(driver.Driver):
    def prepare(self) -> None:
        n = int(self.cfg["N"])
        g = self.generator()
        self.a = self.operand((n, n), g)
        self.b = self.operand((n,), g)
        self.run_units(1)

    def unit(self, i: int):
        linalg = self.ozt.linalg
        fac = linalg.lu_factor(self.a, mode=self.mode, block=int(self.cfg["NB"]),
                               panel=self.cfg["panel"])
        return linalg.lu_solve(fac, self.b)

    def products(self) -> List[roofline.Product]:
        return roofline.lu_products(int(self.cfg["N"]), int(self.cfg["NB"]), self.ns)

    def work(self) -> float:
        return roofline.hpl_flops(int(self.cfg["N"]))

    def judge(self, i: int, out) -> Dict[str, float]:
        return self.reference().numbers(self.a, out, self.b)

    def control(self) -> Dict[str, float]:
        ref = self.reference()
        return ref.numbers(self.a, ref.control(self.a, self.b), self.b)
