"""The plain reference of ozIMMU's AUTO rule: which mode a real FP64 GEMM
C = A @ B runs in ``fp64_int8_auto`` with an average-loss threshold.

Written from ozIMMU's estimator and selection (``src/split.cu:300-518``):

- each element of A is scaled by its row's largest exponent, each of B by
  its column's; an element needs ``required = (group max exponent field
  + 1 - its exponent field) + 53`` bits of mantissa space to be split
  without loss, and 0 where it is exactly zero or its group's largest
  exponent field is 0;
- with ns slices of b bits each it loses ``max(0, required - ns·b)`` bits,
  where ``b = min(7, (31 - ceil(log2 k)) // 2)`` keeps one slice pair's
  dot product of length k inside int32;
- the losses are summed over A and B and averaged over their
  ``m·k + k·n`` elements; the mode is ``fp64_int8_<ns>`` for the smallest
  ns in 3..18 whose average is within the threshold, else ``dgemm``.

Each total is summed directly, every candidate ns over every element, in
blocks of rows of A and of columns of B, so that 8192² operands fit on
the card beside the program's buffers.  ``reference/gemm.py`` judges the
product itself.
"""

from __future__ import annotations

from typing import Dict, List

import torch

NS = list(range(3, 19))
FALLBACK = "dgemm"
#: elements of one block (int64 temporaries of a few hundred MB on the card)
BLOCK_ELEMS = 1 << 24
_ABS = (1 << 63) - 1


def bits_per_slice(k: int) -> int:
    """b: the mantissa bits of one int8 slice at contraction length k."""
    ceil_log2_k = max(k - 1, 0).bit_length()
    return max(0, min(7, (31 - ceil_log2_k) // 2))


def _group_totals(rows: torch.Tensor, b: int) -> List[int]:
    """The loss totals of ``rows`` [r, k] for each ns in NS, each row one
    scale group."""
    bits = rows.contiguous().view(torch.int64)
    e = (bits >> 52) & 0x7FF
    eg = e.amax(dim=1, keepdim=True)
    needed = (bits & _ABS) != 0
    required = torch.where(needed & (eg > 0), eg + 1 - e + 53, torch.zeros_like(e))
    return [int((required - ns * b).clamp_(min=0).sum()) for ns in NS]


def loss_totals(a: torch.Tensor, b: torch.Tensor) -> List[int]:
    """The loss totals for ns = 3..18 over A [m, k] by rows and B [k, n] by
    columns."""
    k = a.shape[1]
    width = bits_per_slice(k)
    step = max(1, BLOCK_ELEMS // max(k, 1))
    totals = [0] * len(NS)
    for x in (a, b.T):
        for r in range(0, x.shape[0], step):
            totals = [t + u for t, u in zip(totals, _group_totals(x[r:r + step], width))]
    return totals


def averages(a: torch.Tensor, b: torch.Tensor) -> Dict[int, float]:
    """ns -> the average bits lost an element of A and B."""
    m, k = a.shape
    n = b.shape[1]
    return dict(zip(NS, (t / float(m * k + k * n) for t in loss_totals(a, b))))


def choose(avg: Dict[int, float], threshold: float) -> str:
    """The mode of the smallest ns whose average ``avg[ns]`` is within
    ``threshold``, else the fallback."""
    for ns in NS:
        if avg[ns] <= threshold:
            return f"fp64_int8_{ns}"
    return FALLBACK


def mode(a: torch.Tensor, b: torch.Tensor, threshold: float) -> str:
    """The mode AUTO runs C = A @ B in at ``threshold``."""
    return choose(averages(a, b), threshold)


def mode_err(chosen: Dict[str, int], want: str) -> float:
    """The share of the AUTO decisions ``chosen`` (mode -> count) that are
    not ``want``; 1 where there are none."""
    total = sum(chosen.values())
    return 1.0 if total == 0 else (total - chosen.get(want, 0)) / total
