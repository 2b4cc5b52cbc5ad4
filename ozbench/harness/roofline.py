"""The yardstick's arithmetic: the card's peaks, and the work and bytes of
each engine product and of each cell's unit of work.

Every count is what the inputs need, not what a kernel happens to move:
each input byte read once, each output byte written once (the rule of the
port's PERF.md since its first kernel table).  A share of a roofline is
the least time these counts allow over the time the trace measured, so a
share above 100 % means the counts are too high or the time leaves out
part of the work.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

#: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W power limit
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12

#: the engine's exponents: one int32 per row of A and per column of B
EXPONENT_BYTES = 4
#: the recombined triple-f32 accumulator, one per output element
S_BYTES = 12


class Product(NamedTuple):
    """One emulated FP64 product alpha·A@B (+ beta·C where ``beta``):
    ``batch`` matrices [m, k] @ [k, n] at ``ns`` int8 slices."""

    batch: int
    m: int
    n: int
    k: int
    ns: Optional[int]
    beta: bool = False


def num_split(mode: str) -> Optional[int]:
    """ns of a fixed ``fp64_int8_<ns>`` mode; None for a mode that fixes
    no number of slices (``fp64_int8_auto`` chooses it call by call), whose
    work the rooflines cannot count."""
    prefix = "fp64_int8_"
    rest = mode[len(prefix):] if mode.startswith(prefix) else ""
    return int(rest) if rest.isdigit() else None


def pairs(ns: int) -> int:
    """Slice-pair products of a mode: ns(ns+1)/2, as the mode defines them."""
    return ns * (ns + 1) // 2


def fp64_flops(p: Product) -> float:
    """The FP64 work the product stands for: 2·m·n·k per matrix."""
    return 2.0 * p.batch * p.m * p.n * p.k


def int8_ops(p: Product) -> float:
    """The int8 work the engine needs: every slice pair, 2·m·n·k each."""
    return pairs(p.ns) * fp64_flops(p)


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card allows: operations at the int8 peak or bytes
    at the HBM peak, whichever is longer."""
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def recombine_least_s(p: Product) -> float:
    """All slice pairs; the planes read once (ns bytes an element of A and
    of B), the triple-f32 accumulator written once."""
    nbytes = p.batch * (p.ns * (p.m * p.k + p.k * p.n) + S_BYTES * p.m * p.n)
    return least_s(int8_ops(p), nbytes)


def split_least_s(p: Product) -> float:
    """Both operands read once (8 B an element) and their planes written
    once (ns B an element), with the row and column exponents."""
    elems = p.m * p.k + p.k * p.n
    nbytes = p.batch * (elems * (8 + p.ns) + EXPONENT_BYTES * (p.m + p.n))
    return least_s(0.0, nbytes)


def epilogue_least_s(p: Product) -> float:
    """The accumulator read (12 B an element) and the output written (8 B),
    C read where beta is set, and the exponents."""
    per_elem = S_BYTES + 8 + (8 if p.beta else 0)
    nbytes = p.batch * (per_elem * p.m * p.n + EXPONENT_BYTES * (p.m + p.n))
    return least_s(0.0, nbytes)


def engine_least_s(p: Product) -> float:
    """The whole product: its int8 work, or A and B read once, C read where
    beta is set and the output written once, at 8 B an element."""
    elems = p.m * p.k + p.k * p.n + p.m * p.n * (2 if p.beta else 1)
    return least_s(int8_ops(p), 8.0 * p.batch * elems)


def hpl_flops(n: int) -> float:
    """HPL's operation count for one solve of order n: 2/3·n³ + 3/2·n²."""
    return 2.0 / 3.0 * n**3 + 1.5 * n**2


def lu_products(n: int, nb: int, ns: Optional[int]) -> List[Product]:
    """The engine products of one right-looking blocked LU of order n with
    block nb: at each step with a trailing block, U12 = inv(L11)·A12 and
    the trailing update A22 − L21·U12 (beta = 1)."""
    out = []
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = n - j - jb
        if rest > 0:
            out.append(Product(1, jb, rest, jb, ns))
            out.append(Product(1, rest, rest, jb, ns, beta=True))
    return out
