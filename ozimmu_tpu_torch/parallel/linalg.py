"""The resident solvers row-sharded over one dim of a ``DeviceMesh``.

Port of the ``mesh=`` paths of ``ozimmu_tpu.linalg`` (``lu_factor``,
``cholesky``), where the matrix planes are sharded ``P(mesh_axis, None)``
and GSPMD partitions every step.  Here every rank of the mesh dim holds a
contiguous block of ``ceil(n / p)`` rows at full width on the mesh's
device (the last blocks may be short or empty) and runs the steps of
:mod:`ozimmu_tpu_torch.linalg` on it, with the collectives of :mod:`.comm`
in the places the partitioner puts them.  A step's root is the rank that
owns its first row.

LU, per step (real or complex, host or device panels):

  1. the panel column ``A[j:, j:j+jb]`` goes to the root, which factors it
     as the one-device step does (``linalg._factor_panel``) and broadcasts
     the pivots;
  2. the step's row swaps run across the full width, L history included
     (getrf); a row that changes owner travels point to point;
  3. the factored panel goes back to the owners of its rows; the root
     gathers ``A12``, forms ``U12 = inv(L11) @ A12`` with one engine GEMM
     and broadcasts it;
  4. every rank runs ``A22 -= L21 @ U12`` on its own rows: one engine call,
     the split and recombine kernels on the card.

Cholesky, per step: the jb x jb diagonal block goes to the root, which
factors and inverts it on the host and broadcasts both; each rank solves
its rows of the panel (``L21 = A21 @ inv(L11)^T``, an engine GEMM), the
panel's rows are gathered on every rank, and each rank runs the trailing
``A22 -= L21 @ L21^T`` on its rows.

The engine splits A by rows, one exponent per row, and B by columns, so a
row block of ``A22 - L21 @ U12`` depends only on those rows of L21 and on
all of U12: each rank computes exactly the bits that one device computes
for its rows, and with host panels the factor equals the one-device one
bit for bit.  A failed panel (an exactly zero pivot, a block that is not
positive definite) is broadcast by the root and raised on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import linalg
from . import comm
from .gemm import device_share, mesh_device


class _Rows:
    """The row blocks of an n x n matrix over the ``p`` ranks of
    ``mesh_axis`` and this rank's block ``local`` (rows [lo, hi))."""

    def __init__(self, a: torch.Tensor, mesh, axis: str):
        self.n = a.shape[0]
        self.mesh, self.axis = mesh, axis
        self.p = comm.axis_size(mesh, axis)
        self.me = comm.axis_index(mesh, axis)
        self.h = -(-self.n // self.p)
        self.lo, self.hi = self.span(self.me)
        # a copy: the caller's tensor stays as it was
        self.local = a[self.lo:self.hi].to(mesh_device(mesh), copy=True).contiguous()

    def span(self, q: int) -> Tuple[int, int]:
        return min(q * self.h, self.n), min((q + 1) * self.h, self.n)

    def part(self, q: int, r0: int, r1: int) -> Tuple[int, int]:
        """Rank ``q``'s rows of the global rows [r0, r1) (possibly empty)."""
        lo, hi = self.span(q)
        return max(r0, lo), max(min(r1, hi), max(r0, lo))

    def owner(self, rows):
        """The coordinate that owns each global row of ``rows``."""
        return rows // self.h

    def mine(self, r0: int, r1: int) -> slice:
        """The local rows that hold the global rows [r0, r1)."""
        s, e = self.part(self.me, r0, r1)
        return slice(s - self.lo, e - self.lo)

    def to_root(self, root: int, r0: int, r1: int, c0: int, c1: int) -> Optional[torch.Tensor]:
        """``A[r0:r1, c0:c1]`` on the rank ``root`` (None elsewhere), each
        owner sending its rows."""
        x = self.local[self.mine(r0, r1), c0:c1]
        if self.me != root:
            comm.exchange({root: x} if x.shape[0] else {}, {}, x, self.mesh, self.axis)
            return None
        shapes = {q: (e - s, c1 - c0) for q in range(self.p) if q != root
                  for s, e in [self.part(q, r0, r1)] if e > s}
        got = comm.exchange({}, shapes, x, self.mesh, self.axis)
        return torch.cat([x if q == root else got[q] for q in range(self.p)
                          if q == root or q in got])

    def from_root(self, root: int, x: Optional[torch.Tensor], r0: int, r1: int, c0: int,
                  c1: int) -> None:
        """Write ``x`` (the root's, rows [r0, r1) x columns [c0, c1)) into
        the owners' rows."""
        mine = self.mine(r0, r1)
        if self.me != root:
            if mine.stop > mine.start:
                got = comm.exchange({}, {root: (mine.stop - mine.start, c1 - c0)},
                                    self.local, self.mesh, self.axis)
                self.local[mine, c0:c1] = got[root]
            return
        sends = {q: x[s - r0:e - r0] for q in range(self.p) if q != root
                 for s, e in [self.part(q, r0, r1)] if e > s}
        comm.exchange(sends, {}, x, self.mesh, self.axis)
        self.local[mine, c0:c1] = x[mine.start + self.lo - r0:mine.stop + self.lo - r0]

    def everywhere(self, r0: int, r1: int, c0: int, c1: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``A[r0:r1, c0:c1]`` on every rank, one broadcast per owner,
        written into ``out`` (default: a new tensor on the mesh's device)
        block by block as the blocks arrive."""
        if out is None:
            out = self.local.new_empty((r1 - r0, c1 - c0))
        for q in range(self.p):
            s, e = self.part(q, r0, r1)
            if e > s:
                blk = (self.local[s - self.lo:e - self.lo, c0:c1] if q == self.me
                       else self.local.new_empty((e - s, c1 - c0)))
                out[s - r0:e - r0].copy_(comm.broadcast(blk, self.mesh, self.axis, q))
        return out

    def swap(self, j: int, p_loc: np.ndarray, piv: np.ndarray) -> None:
        """``linalg._apply_panel_pivots`` on the row blocks: the rows that
        change owner travel point to point, one message per pair of
        ranks."""
        dst, src = linalg._panel_moves(j, p_loc, piv)
        to, frm = self.owner(dst), self.owner(src)
        dev = self.local.device
        rows = lambda g: torch.from_numpy(g - self.lo).to(dev)  # noqa: E731
        sends, shapes, into = {}, {}, {}
        for q in range(self.p):
            if q == self.me:
                continue
            out = (frm == self.me) & (to == q)
            if out.any():
                sends[q] = self.local[rows(src[out])]
            inn = (to == self.me) & (frm == q)
            if inn.any():
                shapes[q] = (int(inn.sum()), self.n)
                into[q] = dst[inn]
        here = (to == self.me) & (frm == self.me)
        kept = self.local[rows(src[here])]  # gathered before any row is written
        got = comm.exchange(sends, shapes, self.local, self.mesh, self.axis)
        self.local[rows(dst[here])] = kept
        for q, x in got.items():
            self.local[rows(into[q])] = x


def _raise_from_root(failed: bool, root: int, rows: _Rows, what: str, error) -> None:
    if failed:
        if error is not None:
            raise error
        raise np.linalg.LinAlgError(f"{what} (found by rank {root} of {rows.axis!r})")


def lu_factor_sharded(a: torch.Tensor, num_split: int, block: int, mesh, mesh_axis: str,
                      panel: str = "host", profile=None) -> Tuple[torch.Tensor, np.ndarray]:
    """Row-sharded resident LU of the float64 or complex128 matrix ``a``
    (the same on every rank of the mesh; left untouched): ``(lu, piv)`` on
    every rank, ``lu`` on ``a``'s device.  ``profile`` (a dict) collects
    this rank's phase seconds as ``linalg.lu_factor`` names them."""
    linalg._check_panel(panel)
    rows = _Rows(a, mesh, mesh_axis)
    with device_share(mesh), linalg._panel_backend(rows.local.device, panel):
        piv = _lu_steps(rows, num_split, block, panel, linalg._Clock(profile, rows.local.device))
    return rows.everywhere(0, rows.n, 0, rows.n, a.new_empty(a.shape)), piv


def _lu_steps(rows: _Rows, num_split: int, block: int, panel: str, clock) -> np.ndarray:
    n, A = rows.n, rows.local
    nb = max(1, min(int(block), n))
    piv = np.arange(n)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        root = rows.owner(j)
        clock.start()
        pnl = rows.to_root(root, j, n, j, rest)
        head = torch.zeros(jb + 1, dtype=torch.int64, device=A.device)
        lu_p = l11inv = error = None
        if rows.me == root:
            try:
                lu_p, p_loc, l11inv = linalg._factor_panel(pnl, j, rest < n, panel, clock)
                head[:jb] = torch.from_numpy(p_loc)
            except np.linalg.LinAlgError as e:
                head[jb], error = 1, e
        head = comm.broadcast(head, rows.mesh, rows.axis, root).cpu().numpy()
        _raise_from_root(bool(head[jb]), root, rows, f"singular matrix: zero pivot in the "
                         f"panel at column {j}", error)
        rows.swap(j, head[:jb], piv)
        rows.from_root(root, lu_p, j, n, j, rest)
        if rest < n:
            a12 = rows.to_root(root, j, rest, rest, n)
            u12 = (linalg._engine(l11inv, a12, num_split) if rows.me == root
                   else A.new_empty((jb, n - rest)))
            u12 = comm.broadcast(u12, rows.mesh, rows.axis, root)
            top = rows.mine(j, rest)
            A[top, rest:] = u12[top.start + rows.lo - j:top.stop + rows.lo - j]
            mine = rows.mine(rest, n)
            if mine.stop > mine.start:
                A[mine, rest:] = linalg._engine(A[mine, j:rest], u12, num_split, -1.0, 1.0,
                                                A[mine, rest:])
        clock.lap("device_update_s", wait=True)
    return piv


def cholesky_sharded(a: torch.Tensor, num_split: int, block: int, mesh, mesh_axis: str,
                     profile=None) -> torch.Tensor:
    """Row-sharded resident Cholesky of the real SPD float64 matrix ``a``
    (the same on every rank; left untouched): L on every rank, on ``a``'s
    device, its strict upper triangle zero."""
    rows = _Rows(a, mesh, mesh_axis)
    with device_share(mesh):
        _cholesky_steps(rows, num_split, block, linalg._Clock(profile, rows.local.device))
    rows.local = torch.tril(rows.local, diagonal=rows.lo)
    return rows.everywhere(0, rows.n, 0, rows.n, a.new_empty(a.shape))


def _cholesky_steps(rows: _Rows, num_split: int, block: int, clock) -> None:
    n, A = rows.n, rows.local
    nb = max(1, min(int(block), n))
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        root = rows.owner(j)
        clock.start()
        d = rows.to_root(root, j, rest, j, rest)
        # L11, inv(L11)^T and an ok flag in one broadcast
        buf = A.new_zeros((2 * jb + 1, jb))
        error = None
        if rows.me == root:
            try:
                l11, inv_t = linalg._cholesky_diagonal(np.ascontiguousarray(d.cpu().numpy()), j)
                buf[:jb], buf[jb:2 * jb], buf[2 * jb, 0] = (
                    torch.from_numpy(l11), torch.from_numpy(inv_t), 1.0)
            except np.linalg.LinAlgError as e:
                error = e
        clock.lap("panel_host_s")
        buf = comm.broadcast(buf, rows.mesh, rows.axis, root)
        _raise_from_root(bool(buf[2 * jb, 0] != 1.0), root, rows, "matrix is not positive "
                         f"definite (diagonal block at {j})", error)
        top = rows.mine(j, rest)
        A[top, j:rest] = buf[top.start + rows.lo - j:top.stop + rows.lo - j]
        if rest < n:
            mine = rows.mine(rest, n)
            if mine.stop > mine.start:
                A[mine, j:rest] = linalg.gemm_int8(A[mine, j:rest], buf[jb:2 * jb], num_split)
            l21 = rows.everywhere(rest, n, j, rest)
            if mine.stop > mine.start:
                A[mine, rest:] = linalg.gemm_int8(A[mine, j:rest], l21.T, num_split, alpha=-1.0,
                                                  beta=1.0, c=A[mine, rest:])
        clock.lap("device_update_s", wait=True)
