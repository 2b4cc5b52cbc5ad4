"""The plain reference of a complex HPL solve, A x = b in complex128, and
its control.

A solution x is judged as HPL 2.3 judges a real one (``HPL_pdtest``),
with the complex moduli that LAPACK's ``ZLANGE('I')`` takes: the scaled
residual ||A x − b||_oo / (eps · (||A||_oo · ||x||_oo + ||b||_oo) · N),
eps = 2^-53, passes below the threshold of 16.  A x is formed in row
blocks from the parts' four float64 products (re·re − im·im, re·im +
im·re), so that it needs no second copy of A, and so that an operand with
zero imaginary parts reads exactly what ``reference/hpl.py`` reads of its
real part.

The control is this reference in the program's place one precision below
complex128: LU with partial pivoting and the triangular solves in
complex64, TF32 off.  :func:`solve` is the plain complex128 solve that the
tests hold the program's solution against.
"""

from __future__ import annotations

from typing import Dict

import torch

from .gemm import _no_tf32

EPS = 2.0**-53
#: rows of A at a time, so that |A| and A x need no second copy of A
BLOCK_ROWS = 2048


def _matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x of a complex [r, n] block and a complex [n] vector, from the
    parts' four float64 products."""
    ar, ai = a.real, a.imag
    xr, xi = x.real, x.imag
    return torch.complex(ar @ xr - ai @ xi, ar @ xi + ai @ xr)


def scaled_residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    n = a.shape[0]
    r_inf = a_inf = 0.0
    for r in range(0, n, BLOCK_ROWS):
        blk = a[r:r + BLOCK_ROWS]
        r_inf = max(r_inf, float((_matvec(blk, x) - b[r:r + BLOCK_ROWS]).abs().max()))
        a_inf = max(a_inf, float(blk.abs().sum(1).max()))
    x_inf = float(x.abs().max())
    b_inf = float(b.abs().max())
    return r_inf / (EPS * (a_inf * x_inf + b_inf) * n)


def numbers(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    return {"hpl_resid": scaled_residual(a, x, b)}


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x from a plain complex128 LU and solves."""
    lu, piv = torch.linalg.lu_factor(a)
    return torch.linalg.lu_solve(lu, piv, b.unsqueeze(1)).squeeze(1)


def control(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x from a complex64 LU and complex64 solves, TF32 off, returned as
    complex128."""
    with _no_tf32():
        return solve(a.to(torch.complex64), b.to(torch.complex64)).to(torch.complex128)
