"""The plain reference of an HPL solve, A x = b, and its control.

A solution x is judged as HPL 2.3 judges it (``HPL_pdtest``): the scaled
residual ||A x − b||_oo / (eps · (||A||_oo · ||x||_oo + ||b||_oo) · N),
with eps = 2^-53 and A x formed in plain float64, passes below HPL.dat's
threshold of 16.

The control is this reference in the program's place one precision
below float64: LU with partial pivoting and the triangular solves in
float32.
"""

from __future__ import annotations

from typing import Dict

import torch

EPS = 2.0**-53
#: rows of A at a time, so that |A| and A x need no second copy of A
BLOCK_ROWS = 2048


def scaled_residual(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    n = a.shape[0]
    r_inf = a_inf = 0.0
    for r in range(0, n, BLOCK_ROWS):
        blk = a[r:r + BLOCK_ROWS]
        r_inf = max(r_inf, float((blk @ x - b[r:r + BLOCK_ROWS]).abs().max()))
        a_inf = max(a_inf, float(blk.abs().sum(1).max()))
    x_inf = float(x.abs().max())
    b_inf = float(b.abs().max())
    return r_inf / (EPS * (a_inf * x_inf + b_inf) * n)


def numbers(a: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> Dict[str, float]:
    return {"hpl_resid": scaled_residual(a, x, b)}


def control(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x from a float32 LU and float32 solves, returned as float64."""
    lu, piv = torch.linalg.lu_factor(a.float())
    return torch.linalg.lu_solve(lu, piv, b.float().unsqueeze(1)).squeeze(1).double()
