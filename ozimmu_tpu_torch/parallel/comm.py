"""The collectives of the distributed layer, on one dim of a ``DeviceMesh``.

The port's counterparts of the ``jax.lax`` collectives that
``ozimmu_tpu/parallel/gemm.py`` calls inside ``shard_map``:

  ===================================  ======================================
  JAX                                  here
  ===================================  ======================================
  ``lax.pmax``                         :func:`pmax` (``all_reduce`` MAX)
  ``lax.psum``                         :func:`psum` (``all_reduce`` SUM)
  ``lax.all_gather(tiled=True)``       :func:`all_gather`, and
                                       :func:`all_gather_k` for k-major
                                       digit planes
  ``lax.psum_scatter(tiled=True)``     :func:`psum_scatter`
                                       (``reduce_scatter_tensor``)
  ``lax.ppermute``                     :func:`ppermute` (``batch_isend_irecv``)
  ``lax.axis_index``                   :func:`axis_index`
  ===================================  ======================================

and :func:`broadcast` and :func:`exchange` (point-to-point messages of
any shape, for the row-sharded solvers of :mod:`.linalg`, whose
collectives XLA's partitioner inserts in the JAX package).

Every rank of the mesh dim's process group calls each of them, as every
device runs a ``shard_map`` body.  A mesh dim is named as in the JAX
package (``"x"``, ``"y"``, ``"k"``).

Several ranks can share one card only over gloo, which moves host memory:
for a gloo group and CUDA tensors each collective copies its operands to
the host and its result back, in the open, and adds the bytes of both
copies to :data:`STAGED_BYTES`.  That path is chosen by the group's
backend, never taken because NCCL failed.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

#: bytes copied between a card and host memory by gloo collectives on CUDA
#: tensors since the process started (or since a caller last reset it)
STAGED_BYTES = 0


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dim ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    global STAGED_BYTES
    STAGED_BYTES += x.numel() * x.element_size()
    return x.cpu()


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    global STAGED_BYTES
    STAGED_BYTES += x.numel() * x.element_size()
    return x.to(like.device)


def _all_reduce(x: torch.Tensor, op, mesh, axis: str) -> torch.Tensor:
    group = mesh.get_group(axis)
    if _staged(group, x):
        out = _host(x).clone()
        dist.all_reduce(out, op, group=group)
        return _back(out, x)
    out = x.clone()
    dist.all_reduce(out, op, group=group)
    return out


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum over ``axis`` (a new tensor)."""
    return _all_reduce(x, dist.ReduceOp.MAX, mesh, axis)


def psum(x: torch.Tensor, mesh, axes: Iterable[str]) -> torch.Tensor:
    """Sum over every mesh dim of ``axes``, one after the other (exact for
    the integer tensors the engine reduces)."""
    for axis in axes:
        x = _all_reduce(x, dist.ReduceOp.SUM, mesh, axis)
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of every rank along ``axis``, concatenated in rank order
    along ``dim`` (``lax.all_gather(..., axis=dim, tiled=True)``).

    ``all_gather_into_tensor`` stacks the blocks on a new leading dim; it
    is moved to just before ``dim`` and merged with it, one copy."""
    group = mesh.get_group(axis)
    p = dist.get_world_size(group)
    x = x.contiguous()
    staged = _staged(group, x)
    src = _host(x) if staged else x
    out = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=src.device)
    dist.all_gather_into_tensor(out.view((p * x.shape[0],) + tuple(x.shape[1:])), src,
                                group=group)
    shape = list(x.shape)
    shape[dim] *= p
    out = out.movedim(0, dim).reshape(shape)
    return _back(out, x) if staged else out


def all_gather_k(x: torch.Tensor, mesh, axis: str, width: int, k_pad: int) -> torch.Tensor:
    """The k-major digit planes of every rank along ``axis`` as one slab:
    ``x`` [..., rows, kl] holds this rank's block of the contraction in
    its first ``width`` columns (zero padding beyond); the result is
    [..., rows, k_pad], rank r's block at columns [r * width, (r + 1) *
    width), zero from ``p * width`` on — the layout the recombine kernel
    reads, written in the one copy that the gather makes anyway."""
    group = mesh.get_group(axis)
    p = dist.get_world_size(group)
    if not width <= x.shape[-1] or k_pad < p * width:
        raise ValueError(f"blocks of {width} of {x.shape[-1]} columns do not gather over {p} "
                         f"ranks into {k_pad}")
    x = x.contiguous()
    staged = _staged(group, x)
    src = _host(x) if staged else x
    blocks = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=src.device)
    dist.all_gather_into_tensor(blocks.view((p * x.shape[0],) + tuple(x.shape[1:])), src,
                                group=group)
    out = torch.empty(tuple(x.shape[:-1]) + (k_pad,), dtype=x.dtype, device=src.device)
    out[..., p * width:].zero_()
    out[..., :p * width].unflatten(-1, (p, width)).copy_(blocks[..., :width].movedim(0, -2))
    return _back(out, x) if staged else out


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Sum over ``axis``, leaving rank ``i`` the i-th of equal blocks along
    ``dim`` (``lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``).
    Over one rank the sum is ``x`` itself, returned as it is."""
    group = mesh.get_group(axis)
    p = dist.get_world_size(group)
    if x.shape[dim] % p:
        raise ValueError(f"{x.shape[dim]} rows do not scatter over {p} ranks")
    if p == 1:
        return x
    # rank i's block first in the i-th of p equal parts: [p * d0, ...]
    x = x.unflatten(dim, (p, -1)).movedim(dim, 0).contiguous().flatten(0, 1)
    staged = _staged(group, x)
    src = _host(x) if staged else x
    out = torch.empty((x.shape[0] // p,) + tuple(x.shape[1:]), dtype=x.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return _back(out, x) if staged else out


def broadcast(x: torch.Tensor, mesh, axis: str, owner: int) -> torch.Tensor:
    """The tensor of the rank at coordinate ``owner`` along ``axis``, on
    every rank of it; the others pass a tensor of the same shape and type,
    whose values are not read."""
    group = mesh.get_group(axis)
    staged = _staged(group, x)
    buf = _host(x.contiguous()) if staged else x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=dist.get_global_rank(group, owner), group=group)
    return _back(buf, x) if staged else buf


def ppermute(x: torch.Tensor, mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists (source, destination) coordinates
    along ``axis``; this rank sends ``x`` to its destination and returns
    what its source sent (a permutation: one of each per rank)."""
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    (dst,) = [d for s, d in perm if s == me]
    (src,) = [s for s, d in perm if d == me]
    x = x.contiguous()
    staged = _staged(group, x)
    send = _host(x) if staged else x
    recv = torch.empty_like(send)
    ops: List[dist.P2POp] = [
        dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group=group),
        dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group=group),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(recv, x) if staged else recv


def exchange(sends: Dict[int, torch.Tensor], recv_shapes: Dict[int, Tuple[int, ...]],
             like: torch.Tensor, mesh, axis: str) -> Dict[int, torch.Tensor]:
    """Point-to-point messages along ``axis``: this rank sends
    ``sends[d]`` to coordinate ``d`` and receives from each coordinate
    ``s`` of ``recv_shapes`` a tensor of that shape, with the dtype and on
    the device of ``like``; returns ``{s: received}``.  Both ends of a
    message take part in the same call, a rank with nothing to send or
    receive may skip it, and no rank messages itself."""
    if not sends and not recv_shapes:
        return {}
    group = mesh.get_group(axis)
    staged = _staged(group, like)
    ops: List[dist.P2POp] = []
    for d, x in sends.items():
        x = x.contiguous()
        ops.append(dist.P2POp(dist.isend, _host(x) if staged else x,
                              dist.get_global_rank(group, d), group=group))
    got = {}
    for s, shape in recv_shapes.items():
        got[s] = torch.empty(shape, dtype=like.dtype, device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, got[s], dist.get_global_rank(group, s), group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return {s: _back(x, like) if staged else x for s, x in got.items()}
