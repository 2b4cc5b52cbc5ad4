"""Wrapper of the CUDA recombine kernel (csrc/recombine.cu).

Port of the TPU kernel ``ozimmu_tpu/ops/recombine_pallas.py::recombine_pallas``.
Its plain PyTorch version is :func:`.recombine.group_totals` followed by
:func:`.recombine.fold_group_totals`; the two are bitwise equal on all
three f32 planes.  The wrapper takes CUDA tensors only and raises on
anything else — there is no fallback.

:func:`launch_plan` decides everything about a launch that depends on the
shape (tile class, padded k, grid, shared memory) in plain Python, so that
the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..schedule import group_schedule
from .recombine import K_ALIGN, acc_shift, padded_k
from .tf32x3 import Triple

#: kernel launches by :func:`recombine` since the process started (or
#: since a caller last reset it)
LAUNCHES = 0

#: the kernel's tile classes, as csrc/recombine.cu instantiates them:
#: (consumer warpgroups, block columns, ring stages, cluster size); a block
#: has 64 rows per consumer warpgroup; a cluster of c blocks shares (by TMA
#: multicast) the B tile of c vertically adjacent output tiles
TILES = ((2, 256, 4, 2), (1, 128, 8, 1))
#: k bytes of one ring stage (one 128-byte swizzle row)
BLOCK_K = 128
#: dynamic shared memory a block may use on Hopper
SMEM_LIMIT = 232_448
#: the most pairs (ns = 18) and groups the kernel's schedule parameter holds
MAX_PAIRS = 171
#: int8 rate of one SM on a 64x128 tile relative to a 128x256 tile, used to
#: weigh the two classes against each other (0.33-0.47 at 4096^3-8192^3 on
#: an H100, tools/torch_recombine_variants.py; PERF.md)
SMALL_TILE_RATE = 0.45


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tile: int  # index into TILES
    block_m: int
    block_n: int
    stages: int
    cluster: int  # blocks sharing one B tile
    k_pad: int  # k zero-padded to K_ALIGN
    tiles: int  # output tiles (rounded up to whole clusters)
    grid: int  # persistent blocks, at most one per SM
    smem_bytes: int
    pairs: int


def _smem_bytes(block_m: int, block_n: int, stages: int) -> int:
    """The ring, a full and an empty mbarrier per stage, and 1024 bytes of
    slack to align the ring (csrc/recombine.cu, Tile::SMEM_BYTES)."""
    return stages * (block_m + block_n) * BLOCK_K + 2 * stages * 8 + 1024


def launch_plan(m: int, n: int, k: int, num_split: int, sms: int,
                tile: Optional[int] = None, batch: int = 1) -> LaunchPlan:
    """The launch of ``batch`` m x n products over ``k`` (the planes' k)
    with ``num_split`` planes on a card with ``sms`` SMs.  Unless ``tile``
    forces a class, the one whose waves of tiles (over the whole batch)
    finish first: waves x tile area / relative rate (the large tile leaves
    most SMs idle on small products)."""
    pairs = num_split * (num_split + 1) // 2
    if pairs > MAX_PAIRS or min(m, n, k, sms, batch) < 1:
        raise ValueError(
            f"no launch for m={m} n={n} k={k} ns={num_split} sms={sms} batch={batch}")

    def units_of(t: int) -> int:  # clusters' units of work
        nc, bn, _, cm = TILES[t]
        return batch * math.ceil(math.ceil(m / (64 * nc)) / cm) * math.ceil(n / bn)

    def cost(t: int) -> float:
        nc, bn, _, cm = TILES[t]
        rate = 1.0 if t == 0 else SMALL_TILE_RATE
        return math.ceil(units_of(t) / (sms // cm)) * 64 * nc * bn / rate

    if tile is None:
        tile = min((t for t in range(len(TILES)) if TILES[t][3] <= sms), key=cost)
    nc, bn, stages, cm = TILES[tile]
    if sms < cm:
        raise ValueError(f"tile class {tile} needs {cm} SMs, the card has {sms}")
    k_pad = padded_k(k)
    units = units_of(tile)
    if units * cm >= 2**31 or num_split * batch >= 2**31:
        raise ValueError(f"{units} units of {batch} matrices exceed the kernel's 32-bit unit index")
    return LaunchPlan(
        tile=tile, block_m=64 * nc, block_n=bn, stages=stages, cluster=cm, k_pad=k_pad,
        tiles=units * cm, grid=cm * min(sms // cm, units),
        smem_bytes=_smem_bytes(64 * nc, bn, stages), pairs=pairs,
    )


@functools.lru_cache(maxsize=64)
def _schedule_arrays(num_split: int, k: int, b: int):
    """The group schedule as the C entry takes it: pair offsets, 0-based
    plane pairs and the two exact f32 factors of each group.  Cached (read
    only): building it costs the host more than issuing the kernel, and
    batched and small products are bound by the host."""
    groups = group_schedule(num_split, k, b)
    shift = acc_shift(num_split, b)
    start = np.cumsum([0] + [len(g.pairs) for g in groups]).astype(np.int32)
    pi = np.array([i - 1 for g in groups for i, _ in g.pairs], dtype=np.int32)
    pj = np.array([j - 1 for g in groups for _, j in g.pairs], dtype=np.int32)
    w = np.array([g.weight_log2(b) + shift for g in groups], dtype=np.int32)
    scale_hi = np.ldexp(1.0, w + 16).astype(np.float32)
    scale_lo = np.ldexp(1.0, w).astype(np.float32)
    arrays = (start, pi, pj, scale_hi, scale_lo)
    for a in arrays:
        a.flags.writeable = False
    return (len(groups), *arrays)


def _pad_k_major(planes: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``planes`` [ns, B, rows, k] copied into a 16-byte aligned
    [ns, B, rows, k_pad] tensor, zero beyond k (zero digits add zero
    products): the copy that planes in the operands' own layout pay."""
    k = planes.shape[-1]
    if k != k_pad:
        planes = F.pad(planes, (0, k_pad - k))
    planes = planes.contiguous()
    return planes if planes.data_ptr() % 16 == 0 else planes.clone()


def _k_major(planes: torch.Tensor, k_pad: int, name: str) -> torch.Tensor:
    """``planes`` as the kernel reads them, [ns, B, rows, k_pad]: contiguous,
    16-byte aligned, k padded to ``k_pad``.  Raises otherwise — nothing is
    copied here."""
    if planes.shape[-1] != k_pad or not planes.is_contiguous() or planes.data_ptr() % 16:
        raise ValueError(
            f"{name} planes {tuple(planes.shape)} (strides {planes.stride()}) are not contiguous, "
            f"16-byte aligned and padded to k_pad={k_pad}")
    return planes


def recombine(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
              tile: Optional[int] = None, b_kmajor: bool = False) -> Triple:
    """The 2^ACC_SHIFT-scaled triple-f32 accumulator [m, n] of the digit
    planes ``da`` int8 [ns, m, k] and ``db`` int8 [ns, k, n]; or, in one
    launch, [B, m, n] of a batch ``da`` [ns, B, m, k], ``db`` [ns, B, k, n],
    matrix i the product of the planes of matrix i.  ``k`` is the true
    contraction length, which sets the group caps.  ``tile`` forces a tile
    class of :data:`TILES` (the launch plan chooses otherwise).

    The kernel reads both operands k-contiguous (8-bit ``wgmma`` takes only
    K-major operands), k zero-padded to a multiple of :data:`K_ALIGN`.
    With ``b_kmajor`` the planes come so, as the engine's split writes
    them: ``da`` [ns, (B,) m, k_pad], ``db`` [ns, (B,) n, k_pad]; anything
    else raises, and nothing is copied.  Without it (the planes of the
    distributed layer and of the plain tests) B's planes are transposed
    into a copy of ns*B*k*n bytes and A's padded where k is not a
    multiple."""
    global LAUNCHES
    if da.device.type != "cuda" or db.device != da.device:
        raise ValueError(
            f"recombine needs CUDA tensors on one device, got {da.device} and {db.device}"
        )
    for name, t in (("da", da), ("db", db)):
        if t.dtype != torch.int8 or t.dim() != da.dim() or t.dim() not in (3, 4) \
                or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous int8 [ns, (B,) ., .] tensor, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    batched = da.dim() == 4
    if not batched:
        da, db = da.unsqueeze(1), db.unsqueeze(1)
    ns, bsz, m, k_in = da.shape
    n = db.shape[2] if b_kmajor else db.shape[3]
    k_b = db.shape[3] if b_kmajor else db.shape[2]
    if ns != num_split or tuple(db.shape[:2]) != (ns, bsz) or k_b != k_in:
        raise ValueError(f"plane shapes {tuple(da.shape)} @ {tuple(db.shape)} do not match "
                         f"ns={num_split} (B k-major: {b_kmajor})")
    k_max = padded_k(k) if b_kmajor else k
    if k_in > k_max or max(m, n, k) >= 2**31:
        raise ValueError(f"unsupported sizes m={m} n={n} k={k_in} (true k={k})")
    if not 3 <= num_split <= 18 or not 1 <= b <= 7:
        raise ValueError(f"unsupported num_split={num_split}, b={b}")
    out = tuple(torch.empty((bsz, m, n), dtype=torch.float32, device=da.device) for _ in range(3))
    if min(bsz, m, n, k_in) == 0:
        out = tuple(o.zero_() for o in out)
        return out if batched else tuple(o[0] for o in out)
    sms = torch.cuda.get_device_properties(da.device).multi_processor_count
    plan = launch_plan(m, n, k_in, num_split, sms, tile, batch=bsz)
    if not b_kmajor:
        da = _pad_k_major(da, plan.k_pad)
        db = _pad_k_major(db.transpose(2, 3), plan.k_pad)
    da, dbt = _k_major(da, plan.k_pad, "A"), _k_major(db, plan.k_pad, "B")
    n_groups, start, pi, pj, shi, slo = _schedule_arrays(num_split, k, b)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    with torch.cuda.device(da.device):
        stream = torch.cuda.current_stream(da.device).cuda_stream
        code = native.lib().oz_recombine(
            da.data_ptr(), dbt.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            m, n, ns, plan.k_pad, bsz, n_groups, ptr(start), ptr(pi), ptr(pj), ptr(shi), ptr(slo),
            plan.tile, plan.grid, plan.smem_bytes, stream,
        )
    native.check(code, "recombine launch")
    LAUNCHES += 1
    return out if batched else tuple(o[0] for o in out)
