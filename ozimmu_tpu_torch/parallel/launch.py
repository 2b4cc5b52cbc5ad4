"""Process-group set-up and the helpers that build sharded operands.

Port of ``ozimmu_tpu.parallel.launch``.  The pieces:

  * :func:`initialize`: ``torch.distributed.init_process_group`` from
    arguments, the ``OZIMMU_*`` variables or ``torchrun`` 's, on the device
    the caller names;
  * :func:`make_mesh_2d_hybrid`: a 2-D (x, y) mesh whose dcn axis is
    hierarchical, hosts outer and each host's ranks inner, so that the
    heavy plane gathers along the other axis stay inside a host;
  * :func:`replicated_f64x`, :func:`shard_local_f64x`,
    :func:`allgather_f64x`: sharded operands as ``DTensor`` s of float64
    (the JAX package's ``F64X`` hi/lo carriage is not needed here), built
    from an array every rank holds, or per shard with O(shard) host
    memory, and gathered back.

The engine's cross-rank reductions are exact int32 sums and the epilogue
is elementwise, so the results are bitwise those of one device, whatever
the mesh and the number of processes.

Topology -> variant (see gemm.py):

  ============================  =====================================
  regime                        variant
  ============================  =====================================
  operands fit every card       ``sharded_gemm_fn`` (all-gather SUMMA)
  huge operands, square mesh    ``sharded_gemm_ring_fn`` (Cannon: two
                                panels in memory, neighbour traffic)
  huge operands, any mesh       ``sharded_gemm_stream_fn``
  tall contraction (huge k,     ``sharded_gemm_k_fn`` (1-D k-sharded,
  modest m*n)                   reduce-scatter of int32 group totals)
  several hosts                 the same variants on a hybrid mesh;
                                the host cut on the axis that gathers
                                fewer bytes (:func:`dcn_axis_for`)
  ============================  =====================================
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import comm


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda",
               backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` over TCP.

    Each value comes from the argument, else from ``OZIMMU_COORDINATOR``
    (host:port), ``OZIMMU_NUM_PROCS`` and ``OZIMMU_PROC_ID``, else from
    ``torchrun`` 's ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``; a value found nowhere raises.

    ``device`` is where this rank's blocks live: ``"cuda"`` (the default;
    the rank's card is ``LOCAL_RANK``, else the rank modulo the number of
    cards) or ``"cpu"``.  The backend is NCCL for CUDA and gloo for the
    CPU.  ``backend="gloo"`` on CUDA is an explicit choice, for several
    ranks sharing one card: the collectives then go through host memory
    (:mod:`.comm`)."""
    env = os.environ
    coord = coordinator_address or env.get("OZIMMU_COORDINATOR")
    if coord is None and env.get("MASTER_ADDR"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    nproc = num_processes or env.get("OZIMMU_NUM_PROCS") or env.get("WORLD_SIZE")
    pid = process_id if process_id is not None else env.get("OZIMMU_PROC_ID", env.get("RANK"))
    missing = [n for n, v in (("coordinator address", coord), ("number of processes", nproc),
                              ("process id", pid)) if v is None]
    if missing:
        raise ValueError(
            f"initialize: no {', '.join(missing)} (pass it, or set OZIMMU_COORDINATOR, "
            "OZIMMU_NUM_PROCS and OZIMMU_PROC_ID, or run under torchrun)"
        )
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", int(pid) % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=int(nproc),
                            rank=int(pid))


def dcn_axis_for(m: int, n: int, k: int, num_split: int, axis_x: str = "x",
                 axis_y: str = "y") -> str:
    """Which 2-D mesh axis should take the cut between hosts.

    SUMMA gathers A's planes along y (ns * (m/x) * k int8 bytes per rank)
    and B's along x (ns * k * (n/y)); the slower fabric belongs on the
    axis that moves FEWER bytes: x when B's gather is the smaller, else y.
    Returns the caller's axis names."""
    return axis_x if n <= m else axis_y


def _hybrid_grid(world: int, hosts: int, dcn_on_x: bool) -> torch.Tensor:
    """The rank grid of :func:`make_mesh_2d_hybrid`: each host's ranks
    (consecutive, as torchrun numbers them) form an (xi, yi) block, xi as
    square as possible, and the hosts are stacked along the dcn axis."""
    local = world // hosts
    xi = math.isqrt(local)
    while local % xi:
        xi -= 1
    yi = local // xi
    grid = torch.arange(world).reshape(hosts, xi, yi)
    if dcn_on_x:
        return grid.reshape(hosts * xi, yi)
    return grid.permute(1, 0, 2).reshape(xi, hosts * yi)


def make_mesh_2d_hybrid(axis_x: str = "x", axis_y: str = "y", dcn_axis: Optional[str] = None,
                        device_type: str = "cuda"):
    """A 2-D (x, y) mesh over every rank, the hosts outer on ``dcn_axis``
    (default x) so that each host's ranks form a contiguous block.  The
    number of hosts is the world size over ``LOCAL_WORLD_SIZE`` (set by
    torchrun); on one host this is :func:`.gemm.make_mesh_2d`."""
    from torch.distributed.device_mesh import DeviceMesh

    from .gemm import make_mesh_2d

    world = dist.get_world_size()
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if hosts <= 1:
        return make_mesh_2d(axis_x=axis_x, axis_y=axis_y, device_type=device_type)
    dcn_axis = dcn_axis or axis_x
    if dcn_axis not in (axis_x, axis_y):
        raise ValueError(f"dcn_axis must be {axis_x!r} or {axis_y!r}, got {dcn_axis!r}")
    return DeviceMesh(device_type, _hybrid_grid(world, hosts, dcn_axis == axis_x),
                      mesh_dim_names=(axis_x, axis_y))


def _placements(mesh, spec: Sequence[Optional[str]]):
    """DTensor placements of a PartitionSpec-like ``spec``: entry d names
    the mesh dim that shards tensor dim d (None: not sharded)."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {axis: Shard(d) for d, axis in enumerate(spec) if axis is not None}
    unknown = set(by_axis) - set(mesh.mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {tuple(spec)} names dims {sorted(unknown)} the mesh lacks")
    return [by_axis.get(name, Replicate()) for name in mesh.mesh_dim_names]


def shard_local_f64x(shape, mesh, spec: Sequence[Optional[str]], fill):
    """A float64 ``DTensor`` of global ``shape`` sharded by ``spec`` (e.g.
    ``("x", "y")``), built with O(shard) host memory per rank.

    ``fill(idx)`` is called once on each rank with its shard's global index
    (a tuple of slices into ``shape``) and returns that block: synthesised
    from the index, read from a memory-mapped file or loaded per shard.
    Nothing global is ever materialised.  Each sharded dim must divide by
    its mesh dim."""
    from torch.distributed.tensor import DTensor

    from .gemm import mesh_device

    shape = tuple(int(s) for s in shape)
    idx = []
    for d, size in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            idx.append(slice(0, size))
            continue
        p = comm.axis_size(mesh, axis)
        if size % p:
            raise ValueError(f"dim {d} of {shape} does not divide over {p} ranks of {axis!r}")
        i, w = comm.axis_index(mesh, axis), size // p
        idx.append(slice(i * w, (i + 1) * w))
    block = np.ascontiguousarray(fill(tuple(idx)), dtype=np.float64)
    want = tuple(s.stop - s.start for s in idx)
    if block.shape != want:
        raise ValueError(f"fill returned a block of shape {block.shape}, expected {want}")
    stride = tuple(int(np.prod(shape[d + 1:])) for d in range(len(shape)))
    return DTensor.from_local(torch.from_numpy(block).to(mesh_device(mesh)), mesh,
                              _placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def replicated_f64x(x: np.ndarray, mesh, spec: Sequence[Optional[str]]):
    """Shard an array that every rank holds alike onto the mesh: a float64
    ``DTensor`` sharded by ``spec``, each rank keeping only its block."""
    x = np.asarray(x)
    return shard_local_f64x(x.shape, mesh, spec, lambda idx: x[idx])


def allgather_f64x(x) -> np.ndarray:
    """A sharded float64 ``DTensor`` as a full numpy array on every rank."""
    out = x.to_local()
    for name, placement in zip(x.device_mesh.mesh_dim_names, x.placements):
        if placement.is_shard():
            out = comm.all_gather(out, x.device_mesh, name, dim=placement.dim)
    return out.cpu().numpy()
