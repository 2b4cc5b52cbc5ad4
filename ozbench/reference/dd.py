"""Double-double arithmetic in plain torch (Dekker, Knuth): exact
products and sums carried as an unevaluated pair hi + lo of float64s.

Each step is one separate elementwise torch operation, which eager torch
never contracts into a fused multiply-add, so the error-free
transformations hold on the CPU and on a CUDA device alike.
"""

from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]

#: Veltkamp's splitter for float64: 2^27 + 1
_SPLITTER = 134217729.0


def two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """two_sum for |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a: torch.Tensor) -> Pair:
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor) -> Pair:
    """p + e == a · b exactly, p = fl(a · b) (no overflow assumed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def add(ah: torch.Tensor, al: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor) -> Pair:
    """(ah + al) + (bh + bl), renormalised."""
    s, e = two_sum(ah, bh)
    return fast_two_sum(s, e + (al + bl))


def sum_last(hi: torch.Tensor, lo: torch.Tensor) -> Pair:
    """The double-double sum along the last dimension, pairwise."""
    while hi.shape[-1] > 1:
        if hi.shape[-1] % 2:
            hi = torch.nn.functional.pad(hi, (0, 1))
            lo = torch.nn.functional.pad(lo, (0, 1))
        hi, lo = add(hi[..., 0::2], lo[..., 0::2], hi[..., 1::2], lo[..., 1::2])
    return hi[..., 0], lo[..., 0]


def gap(xh: torch.Tensor, xl: torch.Tensor, yh: torch.Tensor, yl: torch.Tensor) -> torch.Tensor:
    """|(xh + xl) − (yh + yl)| rounded once to float64."""
    s, e = two_sum(xh, -yh)
    return (s + (e + (xl - yl))).abs()
