"""The yardstick's arithmetic of the complex product's own stages, by the
rule of ``roofline.py``: each input byte read once, each output byte
written once.

A complex product alpha·A·B + beta·C0 runs as four real passes (re·re,
im·im, re·im, im·re) over the splits of A's and B's two parts, each part
split once and read by two passes, and one fold of the four passes into
the complex output.  A driver lists the passes as four ``Product`` each
of the complex product's m, n, k and ns, so each count here is one
pass's quarter of the complex product's, and a reader that sums over the
products counts every part once.
"""

from __future__ import annotations

from .roofline import EXPONENT_BYTES, S_BYTES, Product, least_s

#: the real passes of one complex product
PASSES = 4
#: one complex128 element
Z_BYTES = 16


def zsplit_bytes(p: Product) -> float:
    """A complex product's splits: A's two parts and B's two parts each read
    once (8 B an element), their planes written once (ns B an element),
    and 4 B of exponents a row of each A part and a column of each B part."""
    elems = 2 * (p.m * p.k + p.k * p.n)
    return p.batch * (elems * (8 + p.ns) + EXPONENT_BYTES * 2 * (p.m + p.n))


def zfold_bytes(p: Product) -> float:
    """A complex product's fold: the four passes' triple-f32 accumulators
    read (4 × 12 B an element), C0 read where beta is set (16 B) and the
    complex output written (16 B), with the four passes' exponents."""
    per_elem = PASSES * S_BYTES + Z_BYTES + (Z_BYTES if p.beta else 0)
    return p.batch * (per_elem * p.m * p.n + EXPONENT_BYTES * PASSES * (p.m + p.n))


def zsplit_least_s(p: Product) -> float:
    """One pass's quarter of the complex product's least split time."""
    return least_s(0.0, zsplit_bytes(p)) / PASSES


def zfold_least_s(p: Product) -> float:
    """One pass's quarter of the complex product's least fold time."""
    return least_s(0.0, zfold_bytes(p)) / PASSES
