"""Distributed 2-D-sharded FP64 GEMM over a ``torch.distributed`` device mesh.

Port of ``ozimmu_tpu.parallel.gemm``.  The problem decomposition makes
distribution cheap in one place, and the layer keeps to it: the int8 digit
planes are ~8x smaller than the f64 operands they encode, so what crosses
ranks is int8 planes, int32 exponent vectors and int32 group totals.  No
f64 word crosses a rank boundary except in the native-f64 fallback and in
the host wrappers' final gather of the result.

Algorithm (SUMMA-style, blocks on an (x, y) mesh):

  A [m, k] sharded (x, y)   block [m/x, k/y] per rank
  B [k, n] sharded (x, y)   block [k/x, n/y]

  1. row / column max exponents: local int32 max + MAX over the
     contraction axis (``comm.pmax``);
  2. local split -> int8 digit planes (the CUDA split kernel on the card),
     both operands k-major and zero-padded along k to a multiple of 16
     (A [ns, m/x, k_pad], B [ns, n/y, k_pad]), as the recombine kernel
     reads them;
  3. all-gather A's planes along ``y`` and B's planes along ``x``, so that
     every rank owns full-k slabs (``comm.all_gather_k`` writes the
     k-major slab in the gather's one copy);
  4. local recombination (the CUDA recombine kernel on the card) and the
     exact epilogue -> C block (x, y).

The programming model of the port: a JAX ``Mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims (``"x"``,
``"y"``, or ``"k"`` for the 1-D layout); a ``shard_map`` body is the
function a ``*_fn`` factory returns, which EVERY rank of the mesh calls on
its local blocks (float64 tensors on the mesh's device; the JAX package's
``F64X`` hi/lo carriage is not needed); each ``jax.lax`` collective is a
call of :mod:`.comm` on one mesh dim's process group.  The host wrappers
(:func:`sharded_gemm`, :func:`sharded_gemm_k`, :func:`sharded_gemm_auto`)
are called by every rank with the same global operands; each rank takes
its block, and every rank returns the same global result.  The
pre-sharded entries take and return ``DTensor`` s.  Every host wrapper
and pre-sharded entry plans inside :func:`device_share`: where ranks
share a card (or the host's memory), each sizes its variant, column
panels and epilogue blocks from its share of it.

The epilogue is ``core.gemm._epilogue_SE`` itself (and the complex fold
``_zfold_passes``): elementwise, so applying it per block keeps every
variant bitwise equal to the one-device engine.  The ring, stream and k
variants sum exact int32 group totals over their k panels (or
reduce-scatter them) before one fold, as the JAX variants do through the
plain XLA ``group_totals`` and ``fold_group_totals``: here each step is
``ops.recombine.group_totals_into`` (on the card one launch of the
recombine kernel's totals mode, which stores or adds the totals
[G, m, n] in place), and the fold is ``ops.recombine.fold_totals`` (on
the card the totals-fold kernel), once per product and pass.  No path
runs the plain versions on a card.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.api import apply_op
from ..core.bits import exponent_field
from ..core.gemm import (ZGEMM_PASSES, Exponents, _complex_result, _epilogue_SE, _planes,
                         _recombine_passes, _zfold_passes)
from ..ops.mantissa_loss import decide, loss_totals_with_group_exp
from ..ops.recombine import acc_shift, fold_totals, group_totals_into, padded_k, recombine
from ..ops.split import row_exponent, split_with_exp
from ..schedule import (BYTES_PER_OUTPUT_ELEMENT, bits_per_int8, group_schedule,
                        hbm_budget_bytes, shared_device)
from ..types import ComputeMode, Operation
from . import comm

#: THE single-device epilogue (``alpha * acc + beta * c``): one shared
#: implementation, so that a change of the rounding contract cannot set
#: the distributed path apart from the local one
_epilogue_local = _epilogue_SE


def _bits(k_global: int) -> int:
    """Digit width for the GLOBAL (padded) contraction length."""
    b = bits_per_int8(k_global)
    if b <= 0:
        raise ValueError(f"global k={k_global} too large for int8 emulation")
    return b


def _local_split(x: torch.Tensor, mesh, mesh_axis: Optional[str], ns: int, b: int, axis: int):
    """Split a k-sharded block against the GLOBAL max exponent along the
    contraction axis (``axis`` of the local block): the local max, MAX over
    ``mesh_axis``, then the split kernel (plain version on the CPU), into
    k-major planes zero-padded to ``padded_k`` of the block's k (A [ns,
    rows, k_pad], B [ns, cols, k_pad]: zero digits add zero products)."""
    x = x.contiguous()
    e_row = row_exponent(x, axis)
    if mesh_axis is not None:
        e_row = comm.pmax(e_row, mesh, mesh_axis)
    return split_with_exp(x, e_row, ns, b, axis, padded_k(x.shape[axis]))


def _square(mesh, axis_x: str, axis_y: str, what: str, instead: str) -> int:
    xs, ys = comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y)
    if xs != ys:
        raise ValueError(
            f"ring (Cannon) {what} needs a square mesh, got {xs}x{ys}; use {instead} (all-gather) "
            "instead"
        )
    return xs


def _stream_panels(mesh, axis_x: str, axis_y: str, k_global: int):
    """(L, w, per_y, per_x) of the streamed variant: the contraction in
    L = lcm(xs, ys) aligned k-panels of width w."""
    xs, ys = comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y)
    L = xs * ys // math.gcd(xs, ys)
    if k_global % L:
        raise ValueError(f"streamed SUMMA needs k ({k_global}) divisible by lcm(mesh) = {L}")
    return L, k_global // L, L // ys, L // xs


def _bcast_panel(planes, mesh, mesh_axis: str, owner: int, off: int, width: int):
    """The owner's k-panel of its k-major planes, columns [off, off +
    width) zero-padded to ``padded_k(width)``, on every rank along
    ``mesh_axis``, by a broadcast from the owner.  The JAX package sums
    the owner's panel with zeros from the other ranks (a masked ``psum``);
    the bits are the same, at half the traffic."""
    wp = padded_k(width)
    if comm.axis_index(mesh, mesh_axis) == owner:
        pan = planes.narrow(-1, off, width)
        if wp != width:
            pan = F.pad(pan, (0, wp - width))
    else:
        pan = planes.new_empty(tuple(planes.shape[:-1]) + (wp,))
    return comm.broadcast(pan, mesh, mesh_axis, owner)


def _skew(planes: torch.Tensor, mesh, ring_axis: str, amount: int, q: int) -> torch.Tensor:
    """Rotate ``planes`` along ``ring_axis`` by ``amount`` (the other mesh
    coordinate) in log2(q) rounds: the Cannon initial alignment.

    Every rank of one ring shares ``amount``, so a ring rotates in a round
    as a whole or not at all, and a round moves data only where its bit
    is set (the JAX package permutes in every round and selects)."""
    r = 0
    while (1 << r) < q:
        if (amount >> r) & 1:
            sh = 1 << r
            planes = comm.ppermute(planes, mesh, ring_axis, [((p + sh) % q, p) for p in range(q)])
        r += 1
    return planes


def _ring_shift(q: int):
    """Each rank takes the panel of its neighbour one up the ring."""
    return [((p + 1) % q, p) for p in range(q)]


# ---------------------------------------------------------------------------
# SPMD bodies (every rank calls the returned function on its local blocks)
# ---------------------------------------------------------------------------


def sharded_gemm_fn(mesh, num_split: int, k_global: int, axis_x: str = "x", axis_y: str = "y",
                    alpha: float = 1.0, beta: float = 0.0):
    """The SUMMA DGEMM body ``fn(a, b, c=None) -> C block``:
    ``alpha * (a @ b) + beta * c`` with A, B, C and the output sharded
    (x, y).  ``k_global`` is A's global k; it fixes the digit width."""
    b = _bits(k_global)
    alpha, beta = float(alpha), float(beta)
    shift = acc_shift(num_split, b)

    kp = padded_k(k_global)

    def fn(a, bm, c=None):
        # a: [m/x, k/y], bm: [k/x, n/y]
        da, pa = _local_split(a, mesh, axis_y, num_split, b, axis=1)
        db, pb = _local_split(bm, mesh, axis_x, num_split, b, axis=0)
        da = comm.all_gather_k(da, mesh, axis_y, a.shape[1], kp)  # [ns, m/x, k_pad]
        db = comm.all_gather_k(db, mesh, axis_x, bm.shape[0], kp)  # [ns, n/y, k_pad]
        S = recombine(da, db, num_split, b, k_global, b_kmajor=True)
        del da, db
        return _epilogue_local(S, Exponents(pa, pb, shift), alpha, beta, c)

    return fn


def sharded_gemm_k_fn(mesh, num_split: int, k_global: int, axis_k: str = "k",
                      alpha: float = 1.0, beta: float = 0.0):
    """The 1-D k-sharded (contraction-parallel) DGEMM body
    ``fn(a, b, c=None)``: A [m, k/P], B [k/P, n] per rank; the output (and
    C) comes back row-sharded, [m/P, n].

    Each rank computes the exact int32 group totals [G, m, n] of its k
    panel; one reduce-scatter along k sums them and leaves the rows of C
    sharded.  int32 sums are order-independent, so the bits equal the
    one-device engine's.  m must divide by the mesh size."""
    b = _bits(k_global)
    alpha, beta = float(alpha), float(beta)
    shift = acc_shift(num_split, b)

    def fn(a, bm, c=None):
        da, pa = _local_split(a, mesh, axis_k, num_split, b, axis=1)
        db, pb = _local_split(bm, mesh, axis_k, num_split, b, axis=0)
        totals = group_totals_into(da, db, num_split, b, k_global, b_kmajor=True)
        del da, db
        totals = comm.psum_scatter(totals, mesh, axis_k, dim=1)
        S = fold_totals(totals, num_split, k_global, b)
        m_local = totals.shape[1]
        del totals
        row0 = comm.axis_index(mesh, axis_k) * m_local
        E = Exponents(pa[row0:row0 + m_local], pb, shift)
        return _epilogue_local(S, E, alpha, beta, c)

    return fn


def sharded_zgemm_k_fn(mesh, num_split: int, k_global: int, axis_k: str = "k",
                       alpha: complex = 1.0 + 0j, beta: complex = 0.0 + 0j):
    """The k-sharded complex GEMM body
    ``fn(a_re, a_im, b_re, b_im, c_re=None, c_im=None) -> (re, im)``: the
    four passes of :data:`ZGEMM_PASSES` each reduce-scatter their exact
    int32 group totals, then the complex fold runs on the row block."""
    b = _bits(k_global)
    alpha, beta = complex(alpha), complex(beta)
    shift = acc_shift(num_split, b)

    def fn(a_re, a_im, b_re, b_im, c_re=None, c_im=None):
        da, pa, db, pb = {}, {}, {}, {}
        for idx, x in ((0, a_re), (1, a_im)):
            da[idx], pa[idx] = _local_split(x, mesh, axis_k, num_split, b, axis=1)
        for idx, x in ((0, b_re), (1, b_im)):
            db[idx], pb[idx] = _local_split(x, mesh, axis_k, num_split, b, axis=0)
        SEs = []
        for ap, bp in ZGEMM_PASSES:
            totals = comm.psum_scatter(
                group_totals_into(da[ap], db[bp], num_split, b, k_global, b_kmajor=True),
                mesh, axis_k, dim=1)
            m_local = totals.shape[1]
            row0 = comm.axis_index(mesh, axis_k) * m_local
            SEs.append((fold_totals(totals, num_split, k_global, b),
                        Exponents(pa[ap][row0:row0 + m_local], pb[bp], shift)))
            del totals
        del da, db
        m_l, n_l = SEs[0][0][0].shape
        return _zfold_passes(SEs, m_l, n_l, alpha, beta, c_re, c_im, a_re.device)

    return fn


def sharded_gemm_ring_fn(mesh, num_split: int, k_global: int, axis_x: str = "x",
                         axis_y: str = "y", alpha: float = 1.0, beta: float = 0.0):
    """The ring-streamed (Cannon) DGEMM body for SQUARE meshes, same
    contract as :func:`sharded_gemm_fn`.

    After the skew (A's mesh row i rotated by i, B's mesh column j by j),
    rank (i, j) holds A k-panel (i+j+s) mod q and B k-panel (i+j+s) mod q
    at step s, so one neighbour exchange per ring and step keeps them
    aligned.  Two panels per operand in memory instead of the full-k
    slab; the exact int32 group totals accumulate across steps and are
    folded once."""
    b = _bits(k_global)
    alpha, beta = float(alpha), float(beta)
    q = _square(mesh, axis_x, axis_y, "DGEMM", "sharded_gemm_fn")
    shift = acc_shift(num_split, b)

    def fn(a, bm, c=None):
        da, pa = _local_split(a, mesh, axis_y, num_split, b, axis=1)
        db, pb = _local_split(bm, mesh, axis_x, num_split, b, axis=0)
        da = _skew(da, mesh, axis_y, comm.axis_index(mesh, axis_x), q)
        db = _skew(db, mesh, axis_x, comm.axis_index(mesh, axis_y), q)
        totals = group_totals_into(da, db, num_split, b, k_global, b_kmajor=True)
        for _ in range(1, q):
            da = comm.ppermute(da, mesh, axis_y, _ring_shift(q))
            db = comm.ppermute(db, mesh, axis_x, _ring_shift(q))
            group_totals_into(da, db, num_split, b, k_global, totals, b_kmajor=True)
        del da, db
        S = fold_totals(totals, num_split, k_global, b)
        del totals
        return _epilogue_local(S, Exponents(pa, pb, shift), alpha, beta, c)

    return fn


def sharded_gemm_stream_fn(mesh, num_split: int, k_global: int, axis_x: str = "x",
                           axis_y: str = "y", alpha: float = 1.0, beta: float = 0.0):
    """The panel-streamed (true SUMMA) DGEMM body for ANY mesh shape, same
    contract as :func:`sharded_gemm_fn`.

    The contraction is cut into L = lcm(xs, ys) aligned k-panels; at step
    u the A panel's owner column broadcasts it along y and the B panel's
    owner row along x, and every rank adds the panel product to its exact
    int32 group totals.  The local split planes plus one panel pair in
    memory.  Needs k divisible by L."""
    b = _bits(k_global)
    alpha, beta = float(alpha), float(beta)
    L, w, per_y, per_x = _stream_panels(mesh, axis_x, axis_y, k_global)
    shift = acc_shift(num_split, b)

    def fn(a, bm, c=None):
        da, pa = _local_split(a, mesh, axis_y, num_split, b, axis=1)  # [ns, m/x, k_pad(k/ys)]
        db, pb = _local_split(bm, mesh, axis_x, num_split, b, axis=0)  # [ns, n/y, k_pad(k/xs)]
        totals = None
        for u in range(L):
            oy, ly = divmod(u, per_y)
            ox, lx = divmod(u, per_x)
            a_pan = _bcast_panel(da, mesh, axis_y, oy, ly * w, w)
            b_pan = _bcast_panel(db, mesh, axis_x, ox, lx * w, w)
            totals = group_totals_into(a_pan, b_pan, num_split, b, k_global, totals,
                                       b_kmajor=True)
            del a_pan, b_pan
        del da, db
        S = fold_totals(totals, num_split, k_global, b)
        del totals
        return _epilogue_local(S, Exponents(pa, pb, shift), alpha, beta, c)

    return fn


def sharded_zgemm_fn(mesh, num_split: int, k_global: int, axis_x: str = "x", axis_y: str = "y",
                     alpha: complex = 1.0 + 0j, beta: complex = 0.0 + 0j):
    """The distributed 4-pass complex GEMM body
    ``fn(a_re, a_im, b_re, b_im, c_re=None, c_im=None) -> (re, im)``:
    each re/im plane is split and its int8 planes gathered along the
    contraction axis as in :func:`sharded_gemm_fn` (twice the planes of
    DGEMM per operand), then the four recombinations
    (``core.gemm._recombine_passes``, the CUDA kernel on the card) and the
    complex fold run on the C block.
    All blocks sharded (x, y)."""
    b = _bits(k_global)
    alpha, beta = complex(alpha), complex(beta)
    kp = padded_k(k_global)

    def fn(a_re, a_im, b_re, b_im, c_re=None, c_im=None):
        a_planes, b_planes = {}, {}
        for idx, x in ((0, a_re), (1, a_im)):
            d, p = _local_split(x, mesh, axis_y, num_split, b, axis=1)
            a_planes[idx] = (comm.all_gather_k(d, mesh, axis_y, x.shape[1], kp), p)
        for idx, x in ((0, b_re), (1, b_im)):
            d, p = _local_split(x, mesh, axis_x, num_split, b, axis=0)
            b_planes[idx] = (comm.all_gather_k(d, mesh, axis_x, x.shape[0], kp), p)
        SEs = _recombine_passes(a_planes, b_planes, num_split, b, k_global, b_kmajor=True)
        del a_planes, b_planes
        m_l, n_l = SEs[0][0][0].shape
        return _zfold_passes(SEs, m_l, n_l, alpha, beta, c_re, c_im, a_re.device)

    return fn


def _complex_streamed(mesh, num_split: int, k_global: int, b: int, alpha: complex,
                      beta: complex, split_axes, steps):
    """Shared body of the ring and stream complex variants: split the four
    planes, let ``steps(da, db)`` yield the plane pairs of each step, sum
    the int32 group totals of all four passes over the steps (in place,
    one totals tensor per pass), fold each once."""
    shift = acc_shift(num_split, b)
    a_axis, b_axis = split_axes

    def fn(a_re, a_im, b_re, b_im, c_re=None, c_im=None):
        da, pa, db, pb = {}, {}, {}, {}
        for idx, x in ((0, a_re), (1, a_im)):
            da[idx], pa[idx] = _local_split(x, mesh, a_axis, num_split, b, axis=1)
        for idx, x in ((0, b_re), (1, b_im)):
            db[idx], pb[idx] = _local_split(x, mesh, b_axis, num_split, b, axis=0)
        totals = {pc: None for pc in ZGEMM_PASSES}
        for sa, sb in steps(da, db):
            for ap, bp in ZGEMM_PASSES:
                totals[(ap, bp)] = group_totals_into(sa[ap], sb[bp], num_split, b, k_global,
                                                     totals[(ap, bp)], b_kmajor=True)
            del sa, sb
        del da, db
        SEs = [(fold_totals(totals.pop((ap, bp)), num_split, k_global, b),
                Exponents(pa[ap], pb[bp], shift)) for ap, bp in ZGEMM_PASSES]
        m_l, n_l = SEs[0][0][0].shape
        return _zfold_passes(SEs, m_l, n_l, alpha, beta, c_re, c_im, a_re.device)

    return fn


def sharded_zgemm_ring_fn(mesh, num_split: int, k_global: int, axis_x: str = "x",
                          axis_y: str = "y", alpha: complex = 1.0 + 0j, beta: complex = 0.0 + 0j):
    """The ring-streamed (Cannon) complex GEMM body for SQUARE meshes, same
    contract as :func:`sharded_zgemm_fn`: all four re/im plane sets are
    skewed once and rotate together; each step adds the exact int32 group
    totals of all four pass combinations."""
    b = _bits(k_global)
    q = _square(mesh, axis_x, axis_y, "ZGEMM", "sharded_zgemm_fn")

    def steps(da, db):
        i, j = comm.axis_index(mesh, axis_x), comm.axis_index(mesh, axis_y)
        for idx in (0, 1):
            da[idx] = _skew(da[idx], mesh, axis_y, i, q)
            db[idx] = _skew(db[idx], mesh, axis_x, j, q)
        yield da, db
        for _ in range(1, q):
            for idx in (0, 1):
                da[idx] = comm.ppermute(da[idx], mesh, axis_y, _ring_shift(q))
                db[idx] = comm.ppermute(db[idx], mesh, axis_x, _ring_shift(q))
            yield da, db

    return _complex_streamed(mesh, num_split, k_global, b, complex(alpha), complex(beta),
                             (axis_y, axis_x), steps)


def sharded_zgemm_stream_fn(mesh, num_split: int, k_global: int, axis_x: str = "x",
                            axis_y: str = "y", alpha: complex = 1.0 + 0j,
                            beta: complex = 0.0 + 0j):
    """The panel-streamed (true SUMMA) complex GEMM body for ANY mesh
    shape, same contract as :func:`sharded_zgemm_fn`: both re/im plane
    sets are broadcast per step, and each step adds the exact int32 group
    totals of all four pass combinations."""
    b = _bits(k_global)
    L, w, per_y, per_x = _stream_panels(mesh, axis_x, axis_y, k_global)

    def steps(da, db):
        for u in range(L):
            oy, ly = divmod(u, per_y)
            ox, lx = divmod(u, per_x)
            yield ({i: _bcast_panel(da[i], mesh, axis_y, oy, ly * w, w) for i in (0, 1)},
                   {i: _bcast_panel(db[i], mesh, axis_x, ox, lx * w, w) for i in (0, 1)})

    return _complex_streamed(mesh, num_split, k_global, b, complex(alpha), complex(beta),
                             (axis_y, axis_x), steps)


# ---------------------------------------------------------------------------
# distributed AUTO and the native-f64 fallback
# ---------------------------------------------------------------------------


def _local_loss_totals(x: torch.Tensor, mesh, mesh_axis: Optional[str], b: int, axis: int):
    """Partial mantissa-loss totals of a local block against the GLOBAL
    scale-group max exponent along the contraction axis (the estimator's
    counterpart of :func:`_local_split`)."""
    e_group = torch.amax(exponent_field(x), dim=axis)
    if mesh_axis is not None:
        e_group = comm.pmax(e_group, mesh, mesh_axis)
    return loss_totals_with_group_exp(x, e_group, b, axis)


def sharded_loss_totals_fn(mesh, k_global: int, axis_x: str = "x", axis_y: str = "y"):
    """The distributed mantissa-loss estimator body ``fn(a, b) -> int64[16]``
    (the same on every rank) for blocks sharded as
    :func:`sharded_gemm_fn` takes them: partial totals against the global
    row / column exponents, summed over the mesh.  Exact int64 sums, so
    the totals equal the one-device estimator's on the same operands."""
    b = _bits(k_global)

    def fn(a, bm):
        tot = (_local_loss_totals(a, mesh, axis_y, b, axis=1)
               + _local_loss_totals(bm, mesh, axis_x, b, axis=0))
        return comm.psum(tot, mesh, (axis_x, axis_y))

    return fn


def sharded_zloss_totals_fn(mesh, k_global: int, axis_x: str = "x", axis_y: str = "y"):
    """The distributed complex estimator body
    ``fn(a_re, a_im, b_re, b_im) -> int64[16]``: ONE shared loss counter
    over all four re/im planes (``ops.mantissa_loss.complex_loss_totals``)."""
    b = _bits(k_global)

    def fn(a_re, a_im, b_re, b_im):
        tot = (_local_loss_totals(a_re, mesh, axis_y, b, axis=1)
               + _local_loss_totals(a_im, mesh, axis_y, b, axis=1)
               + _local_loss_totals(b_re, mesh, axis_x, b, axis=0)
               + _local_loss_totals(b_im, mesh, axis_x, b, axis=0))
        return comm.psum(tot, mesh, (axis_x, axis_y))

    return fn


def sharded_dgemm_native_fn(mesh, axis_x: str = "x", axis_y: str = "y", alpha: float = 1.0,
                            beta: float = 0.0):
    """The distributed NATIVE-f64 GEMM body ``fn(a, b, c=None)``, the DGEMM
    fallback of distributed AUTO: all-gather A along y and B along x (f64
    words cross ranks here), one local ``torch.matmul`` in float64, then
    ``alpha * s + beta * c``.  Same shardings as :func:`sharded_gemm_fn`."""
    alpha, beta = float(alpha), float(beta)

    def fn(a, bm, c=None):
        s = torch.matmul(comm.all_gather(a, mesh, axis_y, dim=1),
                         comm.all_gather(bm, mesh, axis_x, dim=0))
        out = alpha * s if alpha != 1.0 else s
        if beta != 0.0:
            out = out + beta * c
        return out

    return fn


# ---------------------------------------------------------------------------
# host wrappers: every rank passes the same global operands
# ---------------------------------------------------------------------------


def _up(v: int, q: int) -> int:
    return -(-v // q) * q


def _as_tensor(x) -> torch.Tensor:
    """A numpy array as a float64 / complex128 CPU tensor (no copy where
    none is needed); a tensor as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype not in (torch.float64, torch.complex128):
            raise TypeError(f"expected float64 or complex128, got {x.dtype}")
        return x
    x = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        x, dtype=np.complex128 if np.iscomplexobj(x) else np.float64))


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` zero-padded to [rows, cols] (zero rows and columns are exact
    in the engine: zero digits, no effect on the max exponents)."""
    if tuple(x.shape) == (rows, cols):
        return x
    out = x.new_zeros((rows, cols))
    out[: x.shape[0], : x.shape[1]] = x
    return out


def mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks: the current CUDA device for a
    ``"cuda"`` mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


#: (the mesh's process groups, this rank's memory) -> ranks_sharing_device
_SHARER_COUNTS = {}


def ranks_sharing_device(mesh) -> int:
    """How many ranks of ``mesh`` keep their blocks in the memory that this
    rank uses: those on this host with the same card, or all of this
    host's ranks for host memory.  Collective over every mesh dim the
    first time a mesh's groups are seen, then cached."""
    import socket

    import torch.distributed as dist

    dev = mesh_device(mesh)
    card = str(getattr(torch.cuda.get_device_properties(dev), "uuid", dev.index)) if (
        dev.type == "cuda") else dev.type
    me = (socket.gethostname(), card)
    key = (tuple(mesh.get_group(name) for name in mesh.mesh_dim_names), me)
    if key not in _SHARER_COUNTS:
        seen = [me]
        for name in mesh.mesh_dim_names:
            parts = [None] * comm.axis_size(mesh, name)
            dist.all_gather_object(parts, seen, group=mesh.get_group(name))
            seen = [x for part in parts for x in part]
        _SHARER_COUNTS[key] = seen.count(me)
    return _SHARER_COUNTS[key]


def device_share(mesh):
    """The context of this rank's part of a call on ``mesh``: inside it
    the default memory budget (``schedule.hbm_budget_bytes``, which sizes
    the variant, the column panels and the epilogue's row blocks) is this
    rank's share of the memory that ranks of the mesh share
    (``schedule.shared_device``).  Every entry of the layer that plans
    with the budget runs in it.  ``OZIMMU_HBM_BUDGET_MB`` is a budget per
    process already: under it nothing is counted."""
    if os.environ.get("OZIMMU_HBM_BUDGET_MB"):
        return contextlib.nullcontext()
    return shared_device(ranks_sharing_device(mesh))


def _block(x: torch.Tensor, mesh, row_axis: Optional[str], col_axis: Optional[str]):
    """This rank's block of the global ``x``: rows split along
    ``row_axis``, columns along ``col_axis`` (None: not split), on the
    mesh's device."""
    idx = []
    for dim, axis in ((0, row_axis), (1, col_axis)):
        if axis is None:
            idx.append(slice(None))
        else:
            w = x.shape[dim] // comm.axis_size(mesh, axis)
            i = comm.axis_index(mesh, axis)
            idx.append(slice(i * w, (i + 1) * w))
    return x[tuple(idx)].to(mesh_device(mesh)).contiguous()


def _unblock(out: torch.Tensor, mesh, row_axis: Optional[str], col_axis: Optional[str],
             dest: torch.Tensor) -> torch.Tensor:
    """Write the global result into ``dest`` on every rank, from each rank's
    block ``out`` (rows split along ``row_axis``, columns along
    ``col_axis``; None: not split).  The blocks are broadcast one at a
    time, along ``col_axis`` within this rank's row of blocks and then
    along ``row_axis``, and each is copied into place as it arrives: the
    mesh's device holds two blocks besides ``out``, and the whole result
    only where ``dest`` lies there."""
    h, w = out.shape
    rows = 1 if row_axis is None else comm.axis_size(mesh, row_axis)
    cols = 1 if col_axis is None else comm.axis_size(mesh, col_axis)
    for j in range(cols):
        in_row = out if col_axis is None else comm.broadcast(out, mesh, col_axis, j)
        for i in range(rows):
            block = in_row if row_axis is None else comm.broadcast(in_row, mesh, row_axis, i)
            dest[i * h:(i + 1) * h, j * w:(j + 1) * w].copy_(block)
    return dest


def _result(blocks, mesh, row_axis: Optional[str], col_axis: Optional[str], m: int, n: int,
            is_np: bool):
    """The caller's global result ``[:m, :n]`` from this rank's block of
    it (a float64 tensor, or the (re, im) pair of a complex result), built
    where the caller gets it: in host memory for numpy operands, as the
    JAX package assembles its result (complex ones as the one-device
    ``gemm`` builds them, so that the bits match it), else on the mesh's
    device (:func:`_result_device_bytes`)."""
    real = isinstance(blocks, torch.Tensor)
    h, w = (blocks if real else blocks[0]).shape
    shape = (h * (1 if row_axis is None else comm.axis_size(mesh, row_axis)),
             w * (1 if col_axis is None else comm.axis_size(mesh, col_axis)))
    dev = torch.device("cpu") if is_np else mesh_device(mesh)
    unblock = lambda blk, dest: _unblock(blk, mesh, row_axis, col_axis, dest)[:m, :n]  # noqa: E731
    if real:
        out = unblock(blocks, torch.empty(shape, dtype=torch.float64, device=dev))
        return np.ascontiguousarray(out.numpy()) if is_np else out
    if is_np:
        re, im = (unblock(b, torch.empty(shape, dtype=torch.float64)) for b in blocks)
        return _complex_result(re, im, True)
    out = torch.empty(shape, dtype=torch.complex128, device=dev)
    for plane, blk in zip(torch.view_as_real(out).unbind(-1), blocks):
        unblock(blk, plane)
    return out[:m, :n]


def _apply_op_host(x: torch.Tensor, op) -> torch.Tensor:
    """BLAS op on a global operand: N / T / C (conjugate transpose, exact;
    the reference degrades OP_C to OP_T, src/cublas.cu:50-56)."""
    return apply_op(x, Operation.parse(op))


def _run_2d(a, b, num_split: int, mesh, axis_x: str, axis_y: str, variant: str, alpha, beta,
            c, complex_: bool):
    """One 2-D variant on padded global tensors: scatter, run; returns this
    rank's block of the result (the (re, im) pair for complex)."""
    k = a.shape[1]
    blk = lambda x: _block(x, mesh, axis_x, axis_y)  # noqa: E731
    if complex_:
        fn = _VARIANT_FNS[variant][1](mesh, num_split, k, axis_x, axis_y, complex(alpha),
                                      complex(beta))
        ops = [*_planes(blk(a)), *_planes(blk(b))]
        if beta != 0:
            ops += _planes(blk(c))
        return tuple(fn(*ops))
    fn = _VARIANT_FNS[variant][0](mesh, num_split, k, axis_x, axis_y, float(alpha), float(beta))
    return fn(blk(a), blk(b), blk(c) if beta != 0 else None)


def _global_operands(a, b, c, op_a, op_b):
    """(is_np, a, b, c, complex_) with the ops applied; checks shapes."""
    is_np = not isinstance(a, torch.Tensor)
    a = _apply_op_host(_as_tensor(a), op_a)
    b = _apply_op_host(_as_tensor(b), op_b)
    c = None if c is None else _as_tensor(c)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    complex_ = any(x is not None and x.is_complex() for x in (a, b, c))
    if complex_:
        a, b = a.to(torch.complex128), b.to(torch.complex128)
        c = None if c is None else c.to(torch.complex128)
    return is_np, a, b, c, complex_


def _padded_2d(m: int, n: int, k: int, mesh, axis_x: str, axis_y: str):
    """A is (x, y): m | x, k | y; B is (x, y): k | x, n | y."""
    xs, ys = comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y)
    return _up(m, xs), _up(n, ys), _up(k, xs * ys // math.gcd(xs, ys))


def sharded_gemm(a, b, num_split: int, mesh, axis_x: str = "x", axis_y: str = "y",
                 ring: bool = False, alpha=1.0, beta=0.0, c=None, op_a="N", op_b="N",
                 variant: Optional[str] = None):
    """``alpha * op(a) @ op(b) + beta * c`` on the mesh, called by every
    rank with the same global operands (numpy arrays or tensors); every
    rank returns the same global result (numpy in, numpy out, assembled in
    host memory; a tensor comes back on the mesh's device).

    ``variant``: "summa" (all-gather, the default), "ring" (Cannon, square
    meshes) or "stream" (panel-streamed, any mesh); ``ring=True`` is an
    alias of ``variant="ring"``.  Complex operands run the distributed
    ZGEMM of the same variant.  ``op_a`` / ``op_b`` take N / T / C.

    Dims need not divide the mesh: the operands are zero-padded to shard
    multiples and the result sliced back.  The digit width follows the
    padded k (what the engine contracts over)."""
    if variant is None:
        variant = "ring" if ring else "summa"
    with device_share(mesh):
        return _sharded_2d(*_global_operands(a, b, c, op_a, op_b), num_split, mesh, axis_x,
                           axis_y, variant, alpha, beta)


def _sharded_2d(is_np: bool, a, b, c, complex_: bool, num_split: int, mesh, axis_x: str,
                axis_y: str, variant: str, alpha, beta):
    """:func:`sharded_gemm` on the operands :func:`_global_operands` made."""
    if variant not in _VARIANT_FNS:
        raise ValueError(f"variant must be one of {sorted(_VARIANT_FNS)}, got {variant!r}")
    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")
    (m, k), n = a.shape, b.shape[1]
    m_p, n_p, k_p = _padded_2d(m, n, k, mesh, axis_x, axis_y)
    a, b = _pad(a, m_p, k_p), _pad(b, k_p, n_p)
    c = None if c is None else _pad(c, m_p, n_p)
    out = _run_2d(a, b, num_split, mesh, axis_x, axis_y, variant, alpha, beta, c, complex_)
    return _result(out, mesh, axis_x, axis_y, m, n, is_np)


def sharded_gemm_k(a, b, num_split: int, mesh=None, axis_k: str = "k", alpha=1.0, beta=0.0,
                   c=None):
    """The 1-D contraction-parallel variant on global operands (every rank
    passes the same ones, every rank gets the result): A (None, k),
    B (k, None) over a 1-D mesh (default: every rank, on CUDA), m and k
    zero-padded to shard multiples.  Complex operands run
    :func:`sharded_zgemm_k_fn`."""
    if mesh is None:
        mesh = _mesh_1d("cuda", axis_k)
    with device_share(mesh):
        return _sharded_k(*_global_operands(a, b, c, "N", "N"), num_split, mesh, axis_k, alpha,
                          beta)


def _sharded_k(is_np: bool, a, b, c, complex_: bool, num_split: int, mesh, axis_k: str, alpha,
               beta):
    """:func:`sharded_gemm_k` on the operands :func:`_global_operands` made."""
    P = comm.axis_size(mesh, axis_k)
    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")
    (m, k), n = a.shape, b.shape[1]
    m_p, k_p = _up(m, P), _up(k, P)
    a, b = _pad(a, m_p, k_p), _pad(b, k_p, n)
    c = None if c is None else _pad(c, m_p, n)
    blk_a = _block(a, mesh, None, axis_k)
    blk_b = _block(b, mesh, axis_k, None)
    if complex_:
        fn = sharded_zgemm_k_fn(mesh, num_split, k_p, axis_k, complex(alpha), complex(beta))
        ops = [*_planes(blk_a), *_planes(blk_b)]
        if beta != 0:
            ops += _planes(_block(c, mesh, axis_k, None))
        return _result(tuple(fn(*ops)), mesh, axis_k, None, m, n, is_np)
    fn = sharded_gemm_k_fn(mesh, num_split, k_p, axis_k, float(alpha), float(beta))
    out = fn(blk_a, blk_b, _block(c, mesh, axis_k, None) if beta != 0 else None)
    return _result(out, mesh, axis_k, None, m, n, is_np)


def _mesh_1d(device_type: str, axis: str, ranks=None):
    """A 1-D mesh named ``axis`` over ``ranks`` (default: every rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if ranks is None:
        ranks = torch.arange(dist.get_world_size())
    return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(-1), mesh_dim_names=(axis,))


def sharded_auto_mode_select(a, b, mesh, threshold: Optional[float] = None, axis_x: str = "x",
                             axis_y: str = "y") -> ComputeMode:
    """Distributed AUTO mode selection: the operands sharded as the engine
    will shard them, the distributed estimator, the shared selection loop
    (``ops.mantissa_loss.decide``).

    The totals equal the one-device estimator's (exact int64 sums; zero
    padding loses nothing), so where the mesh divides the shapes the
    choice is ``auto_mode_select``'s.  On padded shapes the digit width
    follows the PADDED k, as in the JAX package (a documented deviation).
    The average divides by the TRUE element count (real planes for
    complex).  Returns an int8 mode or the DGEMM fallback."""
    from ..core.handle import default_handle

    if threshold is None:
        threshold = default_handle().avg_mantissa_loss_threshold
    _, a, b, _, complex_ = _global_operands(a, b, None, "N", "N")
    (m, k), n = a.shape, b.shape[1]
    m_p, n_p, k_p = _padded_2d(m, n, k, mesh, axis_x, axis_y)
    blk = lambda x: _block(x, mesh, axis_x, axis_y)  # noqa: E731
    a, b = blk(_pad(a, m_p, k_p)), blk(_pad(b, k_p, n_p))
    if complex_:
        totals = sharded_zloss_totals_fn(mesh, k_p, axis_x, axis_y)(*_planes(a), *_planes(b))
        denom = 2.0 * (m * k + k * n)
    else:
        totals = sharded_loss_totals_fn(mesh, k_p, axis_x, axis_y)(a, b)
        denom = float(m * k + k * n)
    return decide(totals, denom, threshold)


def _sharded_dgemm_native(is_np: bool, a, b, c, mesh, axis_x: str, axis_y: str, alpha, beta):
    """The native-f64 fallback on global tensors: pad, scatter, run
    :func:`sharded_dgemm_native_fn`, gather, slice.  Complex operands run
    the four real plane products and fold re / im with the complex alpha
    and beta on each rank's block (elementwise: the same bits as on the
    gathered result)."""
    (m, k), n = a.shape, b.shape[1]
    m_p, n_p, k_p = _padded_2d(m, n, k, mesh, axis_x, axis_y)
    blk = lambda x: _block(x, mesh, axis_x, axis_y)  # noqa: E731
    if a.is_complex() or b.is_complex():
        ar, ai = (blk(p) for p in _planes(_pad(a, m_p, k_p)))
        br, bi = (blk(p) for p in _planes(_pad(b, k_p, n_p)))
        fn = sharded_dgemm_native_fn(mesh, axis_x, axis_y, 1.0, 0.0)
        out = complex(alpha) * torch.complex(fn(ar, br) - fn(ai, bi), fn(ar, bi) + fn(ai, br))
        if beta != 0:
            out = out + complex(beta) * blk(_pad(c, m_p, n_p)).to(torch.complex128)
        return _result(_planes(out), mesh, axis_x, axis_y, m, n, is_np)
    fn = sharded_dgemm_native_fn(mesh, axis_x, axis_y, float(alpha), float(beta))
    cb = blk(_pad(c, m_p, n_p)) if beta != 0 else None
    return _result(fn(blk(_pad(a, m_p, k_p)), blk(_pad(b, k_p, n_p)), cb), mesh, axis_x, axis_y,
                   m, n, is_np)


def sharded_gemm_auto(a, b, num_split="auto", mesh=None, axis_x: str = "x", axis_y: str = "y",
                      alpha=1.0, beta=0.0, c=None, threshold: Optional[float] = None,
                      op_a="N", op_b="N"):
    """:func:`sharded_gemm` with both automatic decisions:

    * ``num_split``: an int, ``"auto"`` / ``ComputeMode.FP64_INT8_AUTO``
      (the default: :func:`sharded_auto_mode_select`, including the
      native-DGEMM fallback, :func:`sharded_dgemm_native_fn`), or any
      ``fp64_int8_N`` mode;
    * the variant (summa / ring / stream / k-sharded), by
      :func:`select_variant`: every variant gives the same bits, so the
      choice is one of memory and traffic.  For tensor operands the
      budget it decides with is less the global result, which this
      wrapper assembles on the mesh's device (:func:`_result_device_bytes`).

    ``mesh`` defaults to :func:`make_mesh_2d` on CUDA."""
    from ..utils.log import log

    if mesh is None:
        mesh = make_mesh_2d()
    with device_share(mesh):
        is_np, a, b, c, complex_ = _global_operands(a, b, c, op_a, op_b)
        (m, k), n = a.shape, b.shape[1]
        if isinstance(num_split, str):
            num_split = ComputeMode(num_split if "_" in num_split else f"fp64_int8_{num_split}")
        if num_split is ComputeMode.FP64_INT8_AUTO:
            sel = sharded_auto_mode_select(a, b, mesh, threshold, axis_x, axis_y)
            log(f"AUTO selected mode = {sel.value} (distributed)")
            if sel is ComputeMode.DGEMM:
                if beta != 0 and c is None:
                    raise ValueError("beta != 0 requires c")
                return _sharded_dgemm_native(is_np, a, b, c, mesh, axis_x, axis_y, alpha, beta)
            num_split = sel.num_split
        elif isinstance(num_split, ComputeMode):
            num_split = num_split.num_split

        budget = hbm_budget_bytes(mesh_device(mesh))
        if not is_np:
            budget -= _result_device_bytes(m, n, complex_)
        v = select_variant(m, n, k, num_split, mesh, axis_x, axis_y, complex_, budget)
        if v == "k":
            kmesh = _mesh_1d(mesh.device_type, "k", mesh.mesh)
            return _sharded_k(is_np, a, b, c, complex_, num_split, kmesh, "k", alpha, beta)
        return _sharded_2d(is_np, a, b, c, complex_, num_split, mesh, axis_x, axis_y, v, alpha,
                           beta)


#: variant name -> (real body factory, complex body factory); every entry
#: gives the same bits as the others: the choice is memory and traffic
_VARIANT_FNS = {
    "summa": (sharded_gemm_fn, sharded_zgemm_fn),
    "ring": (sharded_gemm_ring_fn, sharded_zgemm_ring_fn),
    "stream": (sharded_gemm_stream_fn, sharded_zgemm_stream_fn),
}


# ---------------------------------------------------------------------------
# pre-sharded entries (DTensors in, DTensors out: no global array anywhere)
# ---------------------------------------------------------------------------


def _check_presharded_divisible(m: int, n: int, k: int, xs: int, ys: int) -> None:
    k_gran = xs * ys // math.gcd(xs, ys)
    if m % xs or n % ys or k % k_gran:
        raise ValueError(
            f"pre-sharded operands must divide the mesh exactly: (m={m}) % {xs}, (n={n}) % {ys}, "
            f"(k={k}) % {k_gran} must all be 0 — pad at construction time (shard_local_f64x can "
            "synthesize the zero border per shard)"
        )


def _presharded_variant(m: int, n: int, k: int, num_split: int, mesh, axis_x: str, axis_y: str,
                        complex_: bool, hbm_bytes: Optional[int] = None) -> str:
    """:func:`select_variant` restricted to the 2-D layouts that
    pre-sharded operands have.  A "k" choice needs (None, k) layouts, so
    the first of summa, ring and stream whose model fits is taken instead,
    and if none fits this raises.  (The JAX package turns "k" into "summa"
    without checking summa's budget, ``parallel/gemm.py:1143-1144``.)"""
    if hbm_bytes is None:
        hbm_bytes = hbm_budget_bytes(mesh_device(mesh))
    v = select_variant(m, n, k, num_split, mesh, axis_x, axis_y, complex_, hbm_bytes)
    if v != "k":
        return v
    xs, ys = comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y)
    models = {
        "summa": summa_device_bytes(m, n, k, num_split, xs, ys, complex_),
        "ring": ring_device_bytes(m, n, k, num_split, xs, complex_) if xs == ys > 1 else None,
        "stream": stream_device_bytes(m, n, k, num_split, xs, ys, complex_),
    }
    for v, need in models.items():
        if need is not None and need <= hbm_bytes:
            return v
    raise ValueError(
        f"no 2-D distributed variant fits the HBM budget ({hbm_bytes} B/device) for pre-sharded "
        f"m={m} n={n} k={k} ns={num_split} on a {xs}x{ys} mesh (the k-sharded variant would fit "
        f"but needs (None, k) layouts): {models}; use a larger mesh or raise OZIMMU_HBM_BUDGET_MB"
    )


def _presharded_local(x, name: str, mesh, axis_x: str, axis_y: str) -> torch.Tensor:
    """The local block of a DTensor sharded (axis_x, axis_y) on ``mesh``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"pre-sharded operand {name} must be a DTensor, got {type(x).__name__}")
    if x.device_mesh != mesh or tuple(x.placements) != _placements_2d(mesh, axis_x, axis_y):
        raise ValueError(
            f"pre-sharded operand {name} must be sharded rows on {axis_x!r}, columns on "
            f"{axis_y!r} of the given mesh, got {x.placements} on {x.device_mesh}"
        )
    return x.to_local().contiguous()


def _placements_2d(mesh, axis_x: str, axis_y: str):
    from torch.distributed.tensor import Replicate, Shard

    by_dim = {axis_x: Shard(0), axis_y: Shard(1)}
    return tuple(by_dim.get(name, Replicate()) for name in mesh.mesh_dim_names)


def _as_dtensor(local: torch.Tensor, mesh, axis_x: str, axis_y: str, shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, _placements_2d(mesh, axis_x, axis_y), run_check=False,
                              shape=torch.Size(shape), stride=(shape[1], 1))


def sharded_gemm_presharded(a, b, num_split: int, mesh, axis_x: str = "x", axis_y: str = "y",
                            variant: Optional[str] = None, alpha: float = 1.0, beta: float = 0.0,
                            c=None):
    """Distributed DGEMM on PRE-SHARDED operands: no global array and no
    gather; in and out stay sharded.

    ``a``, ``b`` (and ``c``) are ``DTensor`` s on ``mesh``, rows sharded
    along ``axis_x`` and columns along ``axis_y``, with global shapes that
    divide the mesh exactly (made with
    :func:`.launch.shard_local_f64x`, O(shard) host memory per rank).
    ``variant``: "summa" | "ring" | "stream" | None (the memory models
    choose among the three; see :func:`_presharded_variant`).  Returns the
    C DTensor, sharded the same way."""
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if beta != 0 and c is None:
        raise ValueError("beta != 0 requires c")
    _check_presharded_divisible(m, n, k, comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y))
    with device_share(mesh):
        if variant is None:
            variant = _presharded_variant(m, n, k, num_split, mesh, axis_x, axis_y, False)
        if variant not in _VARIANT_FNS:
            raise ValueError(f"variant must be one of {sorted(_VARIANT_FNS)}, got {variant!r}")
        local = lambda x, nm: _presharded_local(x, nm, mesh, axis_x, axis_y)  # noqa: E731
        fn = _VARIANT_FNS[variant][0](mesh, num_split, k, axis_x, axis_y, float(alpha), float(beta))
        out = fn(local(a, "a"), local(b, "b"), local(c, "c") if beta != 0 else None)
        return _as_dtensor(out, mesh, axis_x, axis_y, (m, n))


def sharded_zgemm_presharded(a_re, a_im, b_re, b_im, num_split: int, mesh, axis_x: str = "x",
                             axis_y: str = "y", variant: Optional[str] = None,
                             alpha: complex = 1.0 + 0j, beta: complex = 0.0 + 0j, c_re=None,
                             c_im=None, conj_a: bool = False, conj_b: bool = False):
    """Distributed ZGEMM on pre-sharded (re, im) float64 DTensor pairs,
    the complex counterpart of :func:`sharded_gemm_presharded`; returns
    the (re, im) DTensor pair.

    ``conj_a`` / ``conj_b`` conjugate an operand on the device (the
    imaginary plane's sign flipped, ``-0.0`` included): the exact
    Operation.C.  Transposes are applied at construction."""
    (m, k), (k2, n) = a_re.shape, b_re.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(a_re.shape)} @ {tuple(b_re.shape)}")
    if beta != 0 and c_re is None:
        raise ValueError("beta != 0 requires c")
    _check_presharded_divisible(m, n, k, comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y))
    with device_share(mesh):
        if variant is None:
            variant = _presharded_variant(m, n, k, num_split, mesh, axis_x, axis_y, True)
        if variant not in _VARIANT_FNS:
            raise ValueError(f"variant must be one of {sorted(_VARIANT_FNS)}, got {variant!r}")
        local = lambda x, nm: _presharded_local(x, nm, mesh, axis_x, axis_y)  # noqa: E731
        ops = [local(a_re, "a_re"), local(a_im, "a_im"), local(b_re, "b_re"), local(b_im, "b_im")]
        if conj_a:
            ops[1] = torch.neg(ops[1])
        if conj_b:
            ops[3] = torch.neg(ops[3])
        if beta != 0:
            ops += [local(c_re, "c_re"), local(c_im, "c_im")]
        fn = _VARIANT_FNS[variant][1](mesh, num_split, k, axis_x, axis_y, complex(alpha),
                                      complex(beta))
        re, im = fn(*ops)
    return (_as_dtensor(re, mesh, axis_x, axis_y, (m, n)),
            _as_dtensor(im, mesh, axis_x, axis_y, (m, n)))


# ---------------------------------------------------------------------------
# memory models and the variant chooser
# ---------------------------------------------------------------------------


def summa_device_bytes(m: int, n: int, k: int, num_split: int, xs: int, ys: int,
                       complex_: bool = False) -> int:
    """Per-rank peak bytes of the all-gather (SUMMA) variant: the GATHERED
    slabs (A's planes over the full k, ns * m/x * k int8, and B's), the
    local operand blocks and the output block (schedule's
    BYTES_PER_OUTPUT_ELEMENT)."""
    f = 2 if complex_ else 1
    mx, ny = -(-m // xs), -(-n // ys)
    return f * (
        num_split * (mx * k + k * ny)  # gathered int8 digit planes
        + 8 * (mx * (k // ys) + (k // xs) * ny)  # local operand blocks
        + BYTES_PER_OUTPUT_ELEMENT * mx * ny
    )


def ring_device_bytes(m: int, n: int, k: int, num_split: int, q: int,
                      complex_: bool = False) -> int:
    """Per-rank peak bytes of the Cannon ring variant on a q x q mesh: TWO
    k-panels per operand instead of the full-k slab."""
    f = 2 if complex_ else 1
    mq, nq, kq = -(-m // q), -(-n // q), -(-k // q)
    return f * (
        2 * num_split * (mq * kq + kq * nq)  # two panel pairs in flight
        + 8 * (mq * kq + kq * nq)  # local operand blocks
        + BYTES_PER_OUTPUT_ELEMENT * mq * nq
    )


def stream_device_bytes(m: int, n: int, k: int, num_split: int, xs: int, ys: int,
                        complex_: bool = False) -> int:
    """Per-rank peak bytes of the panel-streamed variant: the local split
    planes plus one broadcast k-panel pair, double-buffered."""
    f = 2 if complex_ else 1
    L = xs * ys // math.gcd(xs, ys)
    mx, ny = -(-m // xs), -(-n // ys)
    kys, kxs, w = -(-k // ys), -(-k // xs), -(-k // L)
    return f * (
        num_split * (mx * kys + kxs * ny)  # resident local split planes
        + 2 * num_split * (mx * w + w * ny)  # broadcast panels in flight
        + 8 * (mx * kys + kxs * ny)  # local operand blocks
        + BYTES_PER_OUTPUT_ELEMENT * mx * ny
    )


def k_device_bytes(m: int, n: int, k: int, num_split: int, p: int,
                   complex_: bool = False) -> int:
    """Per-rank peak bytes of the k-sharded variant on ``p`` ranks: the
    local operand blocks and their split planes (ns * (m + n) * k/p int8),
    the int32 group totals of the FULL m x n block (4 B a group, G groups
    of ``group_schedule``) and, over several ranks, the reduce-scattered
    rows of them, and the output term over m x n.  The JAX package's test
    counts the operand blocks and the output term only; on one card the
    planes and G - 1 more totals took more than 1.1 x that (PERF.md §6)."""
    f = 2 if complex_ else 1
    kl = -(-k // p)
    totals = 4 * len(group_schedule(num_split, k, _bits(k))) * m * n
    return f * (
        (num_split + 8) * (m + n) * kl  # operand blocks and their int8 planes
        + totals + (totals // p if p > 1 else 0)  # group totals, and the scattered rows
        + BYTES_PER_OUTPUT_ELEMENT * m * n
    )


def _result_device_bytes(m: int, n: int, complex_: bool = False) -> int:
    """Bytes of the global m x n result that the host wrappers assemble on
    the mesh's device for tensor operands, beside the variant's own model
    (for numpy operands it is assembled in host memory, and the gather's
    two blocks in flight stay within the model's output term)."""
    return (16 if complex_ else 8) * m * n


def select_variant(m: int, n: int, k: int, num_split: int, mesh, axis_x: str = "x",
                   axis_y: str = "y", complex_: bool = False,
                   hbm_bytes: Optional[int] = None) -> str:
    """Shape and mesh -> "summa" | "ring" | "stream" | "k".

    * tall contraction (k >= 8 * max(m, n)) whose full m x n output block
      fits every rank -> "k" (moves only int32 group totals; its model,
      :func:`k_device_bytes`, counts the planes and the totals that the
      JAX package's test leaves out, so near the budget the port can say
      "summa" where the JAX package says "k");
    * the all-gather slabs fit -> "summa" (fewest collective steps);
    * over that, square mesh, ring fits -> "ring" (neighbour traffic);
    * else -> "stream" if it fits (any mesh, ~2x the traffic of summa);
    * nothing fits -> ValueError: no plan that would run out of memory.

    ``hbm_bytes`` defaults to ``schedule.hbm_budget_bytes`` of the mesh's
    device."""
    if hbm_bytes is None:
        hbm_bytes = hbm_budget_bytes(mesh_device(mesh))
    xs, ys = comm.axis_size(mesh, axis_x), comm.axis_size(mesh, axis_y)
    # the k variant keeps the FULL m x n output block and its
    # accumulators on every rank: only eligible when that fits
    if k >= 8 * max(m, n) and k_device_bytes(m, n, k, num_split, xs * ys, complex_) <= hbm_bytes:
        return "k"
    if summa_device_bytes(m, n, k, num_split, xs, ys, complex_) <= hbm_bytes:
        return "summa"
    if xs == ys and xs > 1 and ring_device_bytes(m, n, k, num_split, xs, complex_) <= hbm_bytes:
        return "ring"
    if stream_device_bytes(m, n, k, num_split, xs, ys, complex_) <= hbm_bytes:
        return "stream"
    raise ValueError(
        f"no distributed variant fits the HBM budget ({hbm_bytes} B/device) for m={m} n={n} "
        f"k={k} ns={num_split} on a {xs}x{ys} mesh (streamed minimum ~"
        f"{stream_device_bytes(m, n, k, num_split, xs, ys, complex_)} B); use a larger mesh or "
        "raise OZIMMU_HBM_BUDGET_MB"
    )


def make_mesh_2d(n_devices: Optional[int] = None, axis_x: str = "x", axis_y: str = "y",
                 device_type: str = "cuda"):
    """The 2-D mesh over every rank (x * y = world size) with x as square
    as possible, on ``device_type`` (``"cuda"`` unless the caller asks for
    the CPU).  A mesh spans every rank of the default process group, so
    ``n_devices``, where given, must equal the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh spans every rank: n_devices={n}, world size {world}")
    x = int(math.isqrt(n))
    while n % x:
        x -= 1
    return init_device_mesh(device_type, (x, n // x), mesh_dim_names=(axis_x, axis_y))
