"""Triple-float32 expansion arithmetic (~71-bit significand) on torch float32.

The recombination accumulates the int32 group totals in an unevaluated
sum of three float32 components — a "triple-float" in the style of
double-double/quad-double expansion arithmetic (Dekker 1971, Hida-Li-Bailey
QD) — and the epilogue multiplies and adds in it before one rounding to
f64.  The port keeps this representation (rather than accumulating in the
card's real f64) because bitwise parity with ``ozimmu_tpu.ops.tf32x3`` is
what the tests hold it to, and the CUDA recombine kernel folds its group
totals with exactly these steps (csrc/recombine.cu).

Every primitive uses only IEEE round-to-nearest f32 add/sub/mul.  No FMA
is assumed: exact products use Dekker splitting, and a fused multiply-add
would break TwoSum and TwoProd.  PyTorch's eager elementwise kernels never
contract; never run these functions through ``torch.compile``, which can.

All functions operate elementwise on float32 tensors and broadcast.  A
triple is a tuple ``(s0, s1, s2)`` with ``|s0| >= |s1| >= |s2|`` after
renormalization.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_SPLITTER = 4097.0  # 2^12 + 1, Dekker split constant for f32 (exact in f32)


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (no magnitude ordering)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Fast TwoSum requiring |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def f32_split(a):
    """Dekker split: a == hi + lo with hi, lo having <= 12 significand bits."""
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (round-to-nearest, no FMA)."""
    p = a * b
    ah, al = f32_split(a)
    bh, bl = f32_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def zeros(shape, device=None) -> Triple:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return (z, z, z)


def renorm(t: Triple) -> Triple:
    """Renormalize so components are non-overlapping, descending magnitude."""
    s, e2 = quick_two_sum(t[1], t[2])
    s0, e1 = quick_two_sum(t[0], s)
    s1, s2 = quick_two_sum(e1, e2)
    s0, s1 = quick_two_sum(s0, s1)
    return (s0, s1, s2)


def add_term(acc: Triple, x) -> Triple:
    """Accumulate one exactly-representable f32 term into the triple.

    Grows the expansion with a TwoSum cascade; error is confined below the
    third component (~2^-71 relative to the head).
    """
    s0, e0 = two_sum(acc[0], x)
    s1, e1 = two_sum(acc[1], e0)
    s2 = acc[2] + e1
    return (s0, s1, s2)


def add(x: Triple, y: Triple) -> Triple:
    """Triple + triple (components merged head-first, then renormalized)."""
    a = add_term(x, y[0])
    a = add_term(a, y[1])
    a = add_term(a, y[2])
    return renorm(a)


def mul(x: Triple, y: Triple) -> Triple:
    """Triple * triple to ~70-bit accuracy.

    Keeps all O(eps^2) cross terms; drops O(eps^3) ones (x1*y2 etc. are
    kept in plain f32 which is sufficient at that magnitude).
    """
    p00, e00 = two_prod(x[0], y[0])
    p01, e01 = two_prod(x[0], y[1])
    p10, e10 = two_prod(x[1], y[0])
    t2 = x[1] * y[1] + (x[0] * y[2] + x[2] * y[0]) + (e01 + e10)
    acc = (p00, e00, torch.zeros_like(p00))
    acc = add_term(acc, p01)
    acc = add_term(acc, p10)
    acc = add_term(acc, t2)
    return renorm(acc)


def pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 built from exponent bits; e int32 in [-126, 127]."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def scale_pow2(x: Triple, e) -> Triple:
    """Multiply triple by 2^e for int32 ``e`` (elementwise), |e| <= ~250.

    Applied in two half-steps so each factor stays inside f32's normal
    exponent range; magnitudes that still over/underflow saturate to
    inf/0, which callers rely on for drop semantics in aligned adds.
    """
    e = torch.as_tensor(e, dtype=torch.int32, device=x[0].device)
    h1 = torch.clamp(e // 2, -126, 127)
    h2 = torch.clamp(e - h1, -126, 127)
    s1 = pow2_f32(h1)
    s2 = pow2_f32(h2)
    return (x[0] * s1 * s2, x[1] * s1 * s2, x[2] * s1 * s2)


def from_f64_host(v: float) -> Tuple[Tuple[float, float, float], int]:
    """Host-side exact decomposition of a python float:
    ``v = (t0 + t1 + t2) * 2^E`` with f32 components, |t0| in [1, 2).

    Used for static alpha/beta scalars.
    """
    if v == 0.0:
        return ((0.0, 0.0, 0.0), 0)
    if not math.isfinite(v):
        raise ValueError(f"alpha/beta must be finite, got {v}")
    mant, exp = math.frexp(v)  # v = mant * 2^exp, |mant| in [0.5, 1)
    mant *= 2.0
    exp -= 1  # |mant| in [1, 2)
    t0 = np.float32(mant)
    r = mant - float(t0)
    t1 = np.float32(r)
    r -= float(t1)
    t2 = np.float32(r)
    # a 53-bit mantissa always fits in three 24-bit components exactly
    if float(t0) + float(t1) + float(t2) != mant:
        raise ArithmeticError(f"inexact triple decomposition of {v!r}")
    return ((float(t0), float(t1), float(t2)), exp)
