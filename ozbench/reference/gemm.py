"""The plain reference of a real FP64 GEMM, C = A @ B, and its control.

Two numbers judge a product C that the program returned for A and B
(each [m, k] and [k, n], or batches [B, m, k] and [B, k, n]):

- ``entry_err``: at entries drawn from the seed across every matrix of a
  batch, max |C_ij − (A·B)_ij| / (|A|·|B|)_ij, with A·B summed in
  double-double (the exact dot product, to far below one float64 ulp);
- ``rowsum_err``: over every row of every matrix,
  max |Σ_j C_ij − (A·(B·1))_i| / (|A|·(|B|·1))_i, both sums in
  double-double.  Every entry of C lies in one row, so an entry that is
  wrong anywhere shows here, sampled or not.

The control is this reference in the program's place one precision
below float64: A and B rounded to float32 and multiplied in float32 with
TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import numpy as np
import torch

from . import dd

#: elements of one block of the double-double work (a few hundred MB of
#: temporaries on the card)
BLOCK_ELEMS = 1 << 24


def _batched(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x.unsqueeze(0)


def sample(shape_c, entries: int, seed: int):
    """``entries`` (batch, row, column) indices of C drawn from ``seed``."""
    bsz, m, n = (1, *shape_c) if len(shape_c) == 2 else shape_c
    rng = np.random.default_rng([seed % 2**63, 0x5EED])
    return (rng.integers(0, bsz, entries), rng.integers(0, m, entries),
            rng.integers(0, n, entries))


def entry_err(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, idx) -> float:
    a, b, c = _batched(a), _batched(b), _batched(c)
    dev = a.device
    bi, ri, ci = (torch.as_tensor(v, device=dev) for v in idx)
    k = a.shape[2]
    step = max(1, BLOCK_ELEMS // max(k, 1))
    worst = 0.0
    for s in range(0, bi.numel(), step):
        sb, sr, sc = bi[s:s + step], ri[s:s + step], ci[s:s + step]
        rows = a[sb, sr, :]
        cols = b[sb, :, sc]
        h, l = dd.sum_last(*dd.two_prod(rows, cols))
        got = c[sb, sr, sc]
        den = (rows.abs() * cols.abs()).sum(-1)
        err = dd.gap(got, torch.zeros_like(got), h, l) / den
        worst = max(worst, float(err.max()))
    return worst


def rowsum_err(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> float:
    a, b, c = _batched(a), _batched(b), _batched(c)
    worst = 0.0
    for i in range(a.shape[0]):
        ai, bi, ci = a[i], b[i], c[i]
        k, n = bi.shape
        rows = max(1, BLOCK_ELEMS // max(n, 1))
        parts = [dd.sum_last(bi[r:r + rows], torch.zeros_like(bi[r:r + rows]))
                 for r in range(0, k, rows)]
        vh = torch.cat([p[0] for p in parts])
        vl = torch.cat([p[1] for p in parts])
        vabs = bi.abs().sum(1)
        rows = max(1, BLOCK_ELEMS // max(k, n, 1))
        for r in range(0, ai.shape[0], rows):
            blk = ai[r:r + rows]
            p, e = dd.two_prod(blk, vh.unsqueeze(0))
            rh, rl = dd.sum_last(p, e + blk * vl.unsqueeze(0))
            crow = ci[r:r + rows]
            ch, cl = dd.sum_last(crow, torch.zeros_like(crow))
            den = blk.abs() @ vabs
            err = dd.gap(ch, cl, rh, rl) / den
            worst = max(worst, float(err.max()))
    return worst


def numbers(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, entries: int,
            seed: int) -> Dict[str, float]:
    """Both numbers for one returned product."""
    return {
        "entry_err": entry_err(a, b, c, sample(tuple(c.shape), entries, seed)),
        "rowsum_err": rowsum_err(a, b, c),
    }


@contextlib.contextmanager
def _no_tf32() -> Iterator[None]:
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def control(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product in float32 with TF32 off, returned as float64."""
    with _no_tf32():
        return torch.matmul(a.float(), b.float()).double()
