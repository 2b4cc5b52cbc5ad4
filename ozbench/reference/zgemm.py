"""The plain reference of a complex FP64 GEMM, C = alpha·A·B + beta·C0,
and its control.

Two numbers judge a product C that the program returned for complex
A [m, k], B [k, n], C0 [m, n] and complex scalars alpha and beta.  Every
magnitude is BLAS's dcabs1, |z|_1 = |re z| + |im z|, and each entry's
scale is the bound the same product has on those magnitudes:

    den_ij = |alpha|_1 · Σ_k |a_ik|_1·|b_kj|_1 + |beta|_1 · |c0_ij|_1

- ``entry_err``: at entries drawn from the seed, the larger of
  |re(C − R)_ij| and |im(C − R)_ij| over den_ij, with R = alpha·A·B +
  beta·C0 worked out in double-double: the four real dot products
  (re·re, im·im, re·im, im·re) summed exactly, then the alpha and beta
  products and their sums, each in double-double;
- ``rowsum_err``: over every row, the same for Σ_j C_ij against
  alpha·(A·(B·1))_i + beta·(C0·1)_i, every sum in double-double, over the
  row sum of den.  Every entry of C lies in one row, so an entry that is
  wrong anywhere shows here, sampled or not.

The control is this reference in the program's place one precision below
complex128: A, B and C0 rounded to complex64, the product and the
alpha, beta terms formed in complex64 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import dd
from .gemm import BLOCK_ELEMS, _no_tf32, sample

Pair = Tuple[torch.Tensor, torch.Tensor]


def _abs1(x: torch.Tensor) -> torch.Tensor:
    """dcabs1 of each entry: |re| + |im|, float64."""
    return x.real.abs() + x.imag.abs()


def _scalar_abs1(z: complex) -> float:
    return abs(z.real) + abs(z.imag)


def _dd_dot(terms) -> Pair:
    """The double-double sum along the last dimension of the products in
    ``terms``: (sign, x, y) each, y a tensor or a double-double (yh, yl);
    x·yh taken exactly (TwoProd), x·yl rounded, far below the pair's last
    bit."""
    hs, ls = [], []
    for sign, x, y in terms:
        yh, yl = y if isinstance(y, tuple) else (y, None)
        p, e = dd.two_prod(x, yh)
        if yl is not None:
            e = e + x * yl
        hs.append(p if sign > 0 else -p)
        ls.append(e if sign > 0 else -e)
    return dd.sum_last(torch.cat(hs, -1), torch.cat(ls, -1))


def _scale(s: float, x: Pair) -> Pair:
    """s·(xh + xl) as a double-double."""
    p, e = dd.two_prod(torch.full_like(x[0], s), x[0])
    return p, e + s * x[1]


def _combine(alpha: complex, beta: complex, t_re: Pair, t_im: Pair, c_re: Pair,
             c_im: Pair) -> Tuple[Pair, Pair]:
    """alpha·T + beta·C in double-double, T and C as (re, im) pairs."""
    terms_re = [_scale(alpha.real, t_re), _scale(-alpha.imag, t_im),
                _scale(beta.real, c_re), _scale(-beta.imag, c_im)]
    terms_im = [_scale(alpha.real, t_im), _scale(alpha.imag, t_re),
                _scale(beta.real, c_im), _scale(beta.imag, c_re)]

    def total(terms):
        h, l = terms[0]
        for th, tl in terms[1:]:
            h, l = dd.add(h, l, th, tl)
        return h, l

    return total(terms_re), total(terms_im)


def _gap(got: Tuple[Pair, Pair], ref: Tuple[Pair, Pair]) -> torch.Tensor:
    """The larger of the real and imaginary parts' distances of ``got``
    from ``ref``, both (re, im) double-doubles."""
    return torch.maximum(dd.gap(*got[0], *ref[0]), dd.gap(*got[1], *ref[1]))


def _exact(x: torch.Tensor) -> Pair:
    """A float64 tensor as a double-double."""
    x = x.contiguous()
    return x, torch.zeros_like(x)


def entry_err(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, alpha: complex, beta: complex,
              c: torch.Tensor, idx) -> float:
    _, ri, ci = (torch.as_tensor(v, device=a.device) for v in idx)
    k = a.shape[1]
    # each block holds 8 products of k terms an entry, with their errors
    step = max(1, BLOCK_ELEMS // max(8 * k, 1))
    al, be = _scalar_abs1(alpha), _scalar_abs1(beta)
    worst = 0.0
    for s in range(0, ri.numel(), step):
        sr, sc = ri[s:s + step], ci[s:s + step]
        rows = a[sr, :]
        cols = b[:, sc].T
        ar, ai, br, bi = rows.real, rows.imag, cols.real, cols.imag
        t_re = _dd_dot([(1, ar, br), (-1, ai, bi)])
        t_im = _dd_dot([(1, ar, bi), (1, ai, br)])
        c0s = c0[sr, sc]
        ref = _combine(alpha, beta, t_re, t_im, _exact(c0s.real), _exact(c0s.imag))
        got = c[sr, sc]
        den = al * (_abs1(rows) * _abs1(cols)).sum(-1) + be * _abs1(c0s)
        err = _gap((_exact(got.real), _exact(got.imag)), ref) / den
        worst = max(worst, float(err.max()))
    return worst


def _row_sums(x: torch.Tensor) -> Tuple[Pair, Pair]:
    """Σ_j x_ij of a complex [r, n] block in double-double, (re, im)."""
    return dd.sum_last(*_exact(x.real)), dd.sum_last(*_exact(x.imag))


def rowsum_err(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, alpha: complex, beta: complex,
               c: torch.Tensor) -> float:
    m, k = a.shape
    n = b.shape[1]
    rows = max(1, BLOCK_ELEMS // max(n, 1))
    parts = [_row_sums(b[r:r + rows]) for r in range(0, k, rows)]
    v_re = tuple(torch.cat([p[0][i] for p in parts]) for i in (0, 1))
    v_im = tuple(torch.cat([p[1][i] for p in parts]) for i in (0, 1))
    v_abs = _abs1(b).sum(1)
    al, be = _scalar_abs1(alpha), _scalar_abs1(beta)
    # each block holds 4 products of k terms a row, with their errors
    rows = max(1, BLOCK_ELEMS // max(4 * k, n, 1))
    worst = 0.0
    for r in range(0, m, rows):
        blk = a[r:r + rows]
        ar, ai = blk.real.contiguous(), blk.imag.contiguous()
        vr = tuple(x.unsqueeze(0).expand_as(ar) for x in v_re)
        vi = tuple(x.unsqueeze(0).expand_as(ar) for x in v_im)
        t_re = _dd_dot([(1, ar, vr), (-1, ai, vi)])
        t_im = _dd_dot([(1, ar, vi), (1, ai, vr)])
        c0_re, c0_im = _row_sums(c0[r:r + rows])
        ref = _combine(alpha, beta, t_re, t_im, c0_re, c0_im)
        got = _row_sums(c[r:r + rows])
        den = al * (_abs1(blk) @ v_abs) + be * _abs1(c0[r:r + rows]).sum(1)
        err = _gap(got, ref) / den
        worst = max(worst, float(err.max()))
    return worst


def numbers(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, alpha: complex, beta: complex,
            c: torch.Tensor, entries: int, seed: int) -> Dict[str, float]:
    """Both numbers for one returned product C of alpha·A·B + beta·C0."""
    alpha, beta = complex(alpha), complex(beta)
    return {
        "entry_err": entry_err(a, b, c0, alpha, beta, c, sample(tuple(c.shape), entries, seed)),
        "rowsum_err": rowsum_err(a, b, c0, alpha, beta, c),
    }


def control(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, alpha: complex,
            beta: complex) -> torch.Tensor:
    """alpha·A·B + beta·C0 in complex64 with TF32 off, returned as
    complex128."""
    with _no_tf32():
        out = torch.matmul(a.to(torch.complex64), b.to(torch.complex64))
        out = complex(alpha) * out + complex(beta) * c0.to(torch.complex64)
    return out.to(torch.complex128)
