"""``ozimmu_tpu_torch.gemm`` on [m, k] @ [k, n], or, with ``batch``,
``gemm_batched`` on [batch, m, k] @ [batch, k, n]: the same operands every
call, back to back on one stream with at most ``inflight`` calls queued.

Traffic keys: ``m``, ``n``, ``k``, ``batch`` (0: one matrix), ``inflight``,
``soak_s``, ``trace_units``, ``trace_lead_s``, ``sample_entries`` (entries
of each kept product that the reference recomputes)."""

from typing import Dict, List

from harness import driver, roofline


class Driver(driver.Driver):
    def prepare(self) -> None:
        tr = self.tr
        self.batch = int(tr.get("batch", 0))
        lead = (self.batch,) if self.batch else ()
        g = self.generator()
        self.a = self.operand((*lead, tr["m"], tr["k"]), g)
        self.b = self.operand((*lead, tr["k"], tr["n"]), g)
        self.run_units(1)

    def unit(self, i: int):
        if self.batch:
            return self.ozt.gemm_batched(self.a, self.b, mode=self.mode)
        return self.ozt.gemm(self.a, self.b, mode=self.mode)

    def products(self) -> List[roofline.Product]:
        tr = self.tr
        return [roofline.Product(max(self.batch, 1), tr["m"], tr["n"], tr["k"], self.ns)]

    def work(self) -> float:
        return sum(roofline.fp64_flops(p) for p in self.products())

    def judge(self, i: int, out) -> Dict[str, float]:
        return self.reference().numbers(self.a, self.b, out, int(self.tr["sample_entries"]),
                                        self.seed + i)

    def control(self) -> Dict[str, float]:
        ref = self.reference()
        return ref.numbers(self.a, self.b, ref.control(self.a, self.b),
                           int(self.tr["sample_entries"]), self.seed)
