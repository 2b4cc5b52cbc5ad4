"""Rounding and bit assembly between triple-f32 values and exact IEEE f64.

The engine's result exists as ``(triple-f32 mantissa, int32 exponent)``
per element.  :func:`pack_f64` rounds that ~71-bit value to the nearest
IEEE-754 binary64 and assembles its bits in int64 (viewed as float64 at
the end) — the port of ``ozimmu_tpu.ops.pack``, which stands in for the
reference's f64 epilogue kernels (``axby`` src/gemm.cu:124-158).

Rounding contract: round-to-nearest-even (IEEE default).  The packed
result is the CORRECTLY ROUNDED f64 of the exact triple-f32 accumulator
value ``(t0+t1+t2) * 2^E``: the tails fold into the guard-space
significand through composed ROUND-TO-ODD shifts (each >= 2 bits above
the next rounding position — the Boldo-Melquiond double-rounding-safe
pattern), then ONE round-to-nearest-even lands on the target precision
(normal or subnormal).

Torch's ``>>`` on int64 is arithmetic.  Every shift count is clamped into
the range the JAX package clamps it to, and the one logical shift
(:func:`_rne_shift`) masks off the sign fill, so each step matches the
JAX package for every input.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.bits import bits64, exponent_field, mantissa53
from . import tf32x3

Triple = tf32x3.Triple

_F32_MANT = 0x7FFFFF
_F32_IMPL = 1 << 23
_SIGN64 = torch.iinfo(torch.int64).min  # the int64 with only bit 63 set


def _f32_fields(x: torch.Tensor):
    """(sign(+1/-1), exponent field, significand int incl. implicit bit),
    all int32.

    f32 subnormals (ef == 0) carry their raw mantissa with no implicit
    bit — the same significand formula as ef == 1 — so tail components
    that underflowed to subnormal still contribute exactly (pack_f64
    reads their exponent as ``max(ef, 1)``).
    """
    bits = x.view(torch.int32)
    sgn = torch.where(bits < 0, -1, 1).to(torch.int32)
    ef = (bits >> 23) & 0xFF
    m = (bits & _F32_MANT) | torch.where(ef > 0, _F32_IMPL, 0).to(torch.int32)
    return sgn, ef, m


def unpack_f64(c: torch.Tensor) -> Tuple[Triple, torch.Tensor]:
    """Exact decomposition: value(c) == (t0 + t1 + t2) * 2^E.

    Components are exact f32 (21 + 16 + 16 significand bits); ``E`` is
    int32.  Works for normals, subnormals and zeros; NaN/Inf are out of
    the engine's contract (as in the reference).
    """
    field = exponent_field(c)
    m53 = mantissa53(c)
    m_hi = m53 >> 32  # 21 bits incl. the implicit one
    m_lo = m53 & 0xFFFFFFFF
    sgn = torch.where(bits64(c) < 0, -1.0, 1.0).to(torch.float32)
    E = torch.where(field > 0, field, 1) - 1075
    t0 = m_hi.to(torch.float32) * 2.0**32
    t1 = (m_lo >> 16).to(torch.float32) * 2.0**16
    t2 = (m_lo & 0xFFFF).to(torch.float32)
    return (t0 * sgn, t1 * sgn, t2 * sgn), E.to(torch.int32)


def _rto_shift(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Arithmetic shift right by ``s`` with ROUND TO ODD: the result's
    low bit is forced to 1 whenever any shifted-out bit was nonzero.

    Round-to-odd is the double-rounding-safe intermediate (Boldo &
    Melquiond): a subsequent round-to-nearest at a position >= 2 bits
    coarser yields exactly the correctly rounded value of the original.
    """
    c = v >> s
    inexact = (c << s) != v
    return torch.where(inexact, c | 1, c)


def _rne_shift(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``round(q / 2^s)`` with ties to even; ``q`` int64 carries
    round-to-odd sticky information in its low bit, ``s`` in [2, 62].

    Exactness: if the value q represents was inexact below bit 0, bit 0
    is odd, so ``rem`` can never equal the (even) half point — strict
    comparisons then decide correctly; a true tie has exact q and breaks
    on the target's parity.
    """
    one = torch.ones((), dtype=torch.int64, device=q.device)
    rem = q & ((one << s) - 1)
    half = one << (s - 1)
    base = (q >> s) & ((one << (64 - s)) - 1)  # logical shift
    up = (rem > half) | ((rem == half) & ((base & 1) == 1))
    return base + up.to(torch.int64)


def pack_f64(t: Triple, E: torch.Tensor) -> torch.Tensor:
    """Round ``(t0+t1+t2) * 2^E`` to the nearest f64 (ties to even).

    Handles normals, carries across the power-of-two boundary, subnormal
    outputs (single rounding straight from the accumulator — no double
    rounding) and overflow to inf.  Returns a float64 tensor whose bits
    were assembled in int64.
    """
    t = tf32x3.renorm(t)
    E = torch.as_tensor(E, dtype=torch.int32, device=t[0].device)

    s0, ef0, m0 = _f32_fields(t[0])
    s1, ef1, m1 = _f32_fields(t[1])
    s2, ef2, m2 = _f32_fields(t[2])
    is_zero = ef0 == 0  # head is zero/denormal-f32 -> result 0

    # Guard-space significand: q ~ |v| * 2^(55 - e0) (3 guard bits below
    # the 53-bit target), v = t0+t1+t2, e0 = floor(log2|t0|).  The head
    # contributes m0 << 32 exactly; the two tails fold in via two composed
    # round-to-odd steps, and the final round-to-nearest-even happens
    # >= 2 bits above q's bit 0 (see the JAX package's pack_f64x).
    neg = s0 < 0

    def rel(sgn_i, m_i):  # tail significand, signed relative to the head
        sc = m_i.to(torch.int64) << 32
        return torch.where((sgn_i * s0) < 0, -sc, sc)

    # order the tails by magnitude frame (renorm emits |t1| >= |t2|, but
    # crafted inputs may not honor it and the swap is cheap)
    e1 = torch.clamp(ef1, min=1)
    e2 = torch.clamp(ef2, min=1)
    swap = e2 > e1
    ef_a = torch.where(swap, e2, e1)
    ef_b = torch.where(swap, e1, e2)
    sc_a = torch.where(swap, rel(s2, m2), rel(s1, m1))
    sc_b = torch.where(swap, rel(s1, m1), rel(s2, m2))

    d = torch.clamp(ef_a - ef_b, 0, 62).to(torch.int64)  # frames b -> a
    gap = torch.clamp(ef0 - ef_a, 0, 62).to(torch.int64)  # frame a -> q
    s12 = sc_a + _rto_shift(sc_b, d)  # |.| < 2^58, exact sum
    q = (m0.to(torch.int64) << 32) + _rto_shift(s12, gap)

    # If cancellation dropped the UNROUNDED value below 2^(e0) (q below
    # 2^55), the target scale is one binade down (one fewer guard bit).
    need_down = q < (1 << 55)
    e0 = (ef0 - 127) - need_down.to(torch.int32)

    Ef = e0 + E + 1023  # biased f64 exponent (pre-carry), int32
    is_inf = Ef >= 2047  # outright overflow (pre-carry; carry handled below)
    Ef_c = torch.clamp(Ef, -1, 2046)  # keep the int64 shift in range

    # Total right-shift from q to the target significand: 3 guard bits
    # (2 when cancellation moved the scale down) plus the subnormal
    # underflow shift — applied in ONE rounding, directly from q.
    r = torch.clamp(1 - Ef, 0, 62).to(torch.int64)
    s_eff = 3 - need_down.to(torch.int64)
    st = torch.clamp(s_eff + r, 2, 62)
    q_final = _rne_shift(q, st)
    is_sub = Ef <= 0

    # Assemble by addition so mantissa carries ripple into the exponent:
    # q_final == 2^53 after rounding -> exponent += 1 (2046 carries to the
    # inf encoding, which is exactly right); subnormal rounding up to 2^52
    # -> smallest normal.
    bits_normal = (Ef_c.to(torch.int64) << 52) + (q_final - (1 << 52))
    bits = torch.where(is_sub, q_final, bits_normal)
    bits = torch.where(is_inf, torch.full_like(bits, 2047 << 52), bits)
    bits = torch.where(is_zero, torch.zeros_like(bits), bits)

    # sign applies to zeros too (preserves IEEE -0.0 through a round trip)
    bits = torch.where(neg, bits | _SIGN64, bits)
    return bits.view(torch.float64)


def aligned_add(x: Triple, xE: torch.Tensor, y: Triple, yE: torch.Tensor) -> Tuple[Triple, torch.Tensor]:
    """(x * 2^xE) + (y * 2^yE) as (triple, exponent).

    Both operands are rescaled to the elementwise max exponent; a term
    more than ~250 binades below the other underflows to zero in f32 —
    the correct drop semantics (f64 rounding ignores terms >54 binades
    apart anyway).
    """
    m = torch.maximum(xE, yE)
    dx = torch.clamp(xE - m, -300, 0)
    dy = torch.clamp(yE - m, -300, 0)
    xs = tf32x3.scale_pow2(x, dx)
    ys = tf32x3.scale_pow2(y, dy)
    return tf32x3.add(xs, ys), m


def scalar_triple(v: float, shape=(), device=None) -> Tuple[Triple, int]:
    """Static python float -> broadcast triple + exponent (exact)."""
    (t0, t1, t2), e = tf32x3.from_f64_host(v)
    mk = lambda c: torch.full(shape, c, dtype=torch.float32, device=device)  # noqa: E731
    return (mk(t0), mk(t1), mk(t2)), e
