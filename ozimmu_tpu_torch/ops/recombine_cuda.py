"""Wrappers of the CUDA recombine kernel (csrc/recombine.cu) and of its
totals fold.

Port of the TPU kernel ``ozimmu_tpu/ops/recombine_pallas.py::recombine_pallas``.
:func:`recombine` folds straight to the triple; its plain PyTorch version
is :func:`.recombine.group_totals` followed by
:func:`.recombine.fold_group_totals`, and the two are bitwise equal on all
three f32 planes.  The same kernel's totals mode (:func:`group_totals`,
for the streamed variants of ``parallel/``, which sum int32 group totals
over k panels before one fold) writes or adds the int32 group totals
instead, and :func:`fold_totals` folds them (plain versions:
``group_totals`` summed, and ``fold_group_totals``).  The wrappers take
CUDA tensors only and raise on anything else — there is no fallback.

:func:`launch_plan` decides everything about a launch of the kernel that
depends on the shape (tile class, padded k, grid, shared memory, the
window of the bounded-skew walk), and :func:`fold_plan` the fold's, in
plain Python, so that the CPU tests can check them.
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
#: launches of the kernel's totals mode by :func:`group_totals`, and of
#: the totals fold by :func:`fold_totals`, counted the same way
TOTALS_LAUNCHES = 0
FOLD_LAUNCHES = 0

#: the kernel's tile classes, as csrc/recombine.cu instantiates them:
#: (consumer warpgroups, block columns, ring stages, cluster rows, cluster
#: columns); a block has 64 rows per consumer warpgroup; the blocks of one
#: cluster column share (by TMA multicast) their B tile, those of one
#: cluster row their A tile
TILES = ((2, 256, 4, 2, 1), (1, 128, 8, 1, 1), (2, 96, 8, 2, 2))
#: the class that keeps each element's triple in registers across all of a
#: tile's groups and stores it once (no round trip through the output
#: planes at each group end); it folds, so the totals mode never takes it
KEPT_TILE = 2
#: the classes of the totals mode
TOTALS_TILES = (0, 1)
#: :data:`LAUNCHES` by tile class (index into :data:`TILES`)
LAUNCHES_BY_TILE = [0] * len(TILES)
#: k bytes of one ring stage (one 128-byte swizzle row)
BLOCK_K = 128
#: dynamic shared memory a block may use on Hopper
SMEM_LIMIT = 232_448
#: the most pairs (ns = 18) and groups the kernel's schedule parameter holds
MAX_PAIRS = 171
#: int8 rate of one SM on each class's tile relative to the 128x256 tile,
#: at the card's power cap (the 64x128 tile 0.33-0.47 at 4096^3-8192^3 on
#: an H100; the kept class's 2x2 clusters also leave idle the SMs that no
#: whole cluster fits, 12 of 132)
TILE_RATE = (1.0, 0.45, 0.61)
#: the fold of one group, per output element, in units of one pair's int8
#: work over one k on the 128x256 tile: the parked triple's round trip
#: through device memory in classes 0 and 1; in the kept class too small to
#: show in its timings.  With TILE_RATE, fitted to the H100's timings at
#: 16384^2 x 2048 and x 4096, the two sides of the crossover (k ~ 3080 at
#: ns = 9; tools/torch_recombine_variants.py, PERF.md)
GROUP_COST = (9850.0, 9850.0, 0.0)
#: the classes that have the bounded-skew walk (csrc/recombine.cu, kWalk):
#: the 128x256 class, which the plan takes at long k over many tiles
WALK_TILES = (0,)
#: cluster tile rows per band of the persistent walk (csrc/recombine.cu,
#: kGroupM)
GROUP_M = 8
#: the window, in multiples of the steps whose distinct plane tiles fill
#: the card's L2 (lockstep_window): an empirical multiple, not one the L2
#: model gives (that model would keep the window under one L2 of steps,
#: and a third of one lost).  Fitted on an H100 at its power cap
#: (tools/torch_recombine_variants.py --shapes long; PERF.md §6): at
#: 16384^3, ns = 9, launches took 440, 413 and 381 ms at 0.15, 0.33 and 0.6
#: against 377-386 free in one call; 334, 329, 331, 353 and 373 ms at 2, 3,
#: 4, 6 and 8 against 431 free in another; 424-430 at 12.  A tight window
#: holds the whole pack to the slowest cluster's every stall; a loose one
#: lets the pack split again, as the free walk does
WINDOW_SHARE = 3.0
#: the walk pays only where the free walk's pack of clusters splits: where
#: one cluster unit's planes exceed half the L2 (37.7 MB units won 8-25 %
#: at 16384^2 and 24576^2 x 8192, 18.9 MB ones lost 4 % at 16384^2 x
#: 4096), over many waves of units (at least MIN_WAVES units a cluster: 62
#: and 140 won, 35 at 12288^2 and 15.5 at 8192^2 lost 0-15 %), and at up
#: to WALK_MAX_PAIRS pairs (ns = 9 and 12 won at 16384^2, ns = 15 came out
#: even and ns = 18 lost 2-12 %); all read on an H100 (PERF.md §6)
MIN_WAVES = 48
WALK_MAX_PAIRS = 78
#: launches of :func:`recombine` and :func:`group_totals` that took the
#: bounded-skew walk, counted as :data:`LAUNCHES`
LOCKSTEP_LAUNCHES = 0
#: the window and the progress array of the last such launch (last_walk)
_last_walk = None


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    tile: int  # index into TILES
    block_m: int
    block_n: int
    stages: int
    cluster: int  # blocks of one cluster (cluster rows x cluster columns)
    k_pad: int  # k zero-padded to K_ALIGN
    tiles: int  # output tiles (rounded up to whole clusters)
    grid: int  # persistent blocks, at most one per SM
    smem_bytes: int
    pairs: int
    window: int = 0  # the bounded-skew walk's window in steps; 0: the free walk


def _smem_bytes(block_m: int, block_n: int, stages: int) -> int:
    """The ring, a full and an empty mbarrier per stage, and 1024 bytes of
    slack to align the ring (csrc/recombine.cu, Tile::SMEM_BYTES)."""
    return stages * (block_m + block_n) * BLOCK_K + 2 * stages * 8 + 1024


def launch_plan(m: int, n: int, k: int, num_split: int, sms: int,
                tile: Optional[int] = None, batch: int = 1, groups: Optional[int] = None,
                totals: bool = False, l2_bytes: Optional[int] = None) -> LaunchPlan:
    """The launch of ``batch`` m x n products over ``k`` (the planes' k)
    with ``num_split`` planes on a card with ``sms`` SMs, folding
    ``groups`` groups (by default those of ``group_schedule(num_split,
    k)``) or, with ``totals``, writing their int32 totals.  Unless ``tile``
    forces a class, the one whose waves of tiles (over the whole batch)
    finish first: waves x tile area x (the int8 work / the class's rate +
    groups x its fold's cost) — the large tile leaves most SMs idle on
    small products, and the parked triple's round trips weigh most at
    short k.  The totals mode has no triple: it weighs the int8 work alone,
    among :data:`TOTALS_TILES`.

    On a card with an L2 of ``l2_bytes`` (None: no walk), a class of
    :data:`WALK_TILES` takes the bounded-skew walk, with the window of
    :func:`lockstep_window`, where one cluster unit's own plane bytes,
    ``num_split * k_pad * (cluster rows + cluster columns)``, exceed half
    the L2 (the clusters that share a panel find it in L2 only while they
    stay near the same step), where each cluster walks at least
    :data:`MIN_WAVES` units, and at up to :data:`WALK_MAX_PAIRS` pairs: the
    shapes at which the free walk's clusters were measured to drift apart
    and the walk to win."""
    pairs = num_split * (num_split + 1) // 2
    if pairs > MAX_PAIRS or min(m, n, k, sms, batch) < 1:
        raise ValueError(
            f"no launch for m={m} n={n} k={k} ns={num_split} sms={sms} batch={batch}")
    k_pad = padded_k(k)
    if groups is None and not totals:
        groups = len(group_schedule(num_split, k))
    classes = TOTALS_TILES if totals else range(len(TILES))

    def units_of(t: int) -> int:  # clusters' units of work
        nc, bn, _, cm, cn = TILES[t]
        return batch * math.ceil(math.ceil(m / (64 * nc)) / cm) * math.ceil(math.ceil(n / bn) / cn)

    def cost(t: int) -> float:
        nc, bn, _, cm, cn = TILES[t]
        per_element = pairs * k_pad / TILE_RATE[t]
        if not totals:
            per_element += groups * GROUP_COST[t]
        return math.ceil(units_of(t) / (sms // (cm * cn))) * 64 * nc * bn * per_element

    if tile is None:
        tile = min((t for t in classes if TILES[t][3] * TILES[t][4] <= sms), key=cost)
    elif tile not in classes:
        raise ValueError(f"tile class {tile} has no {'totals' if totals else 'fold'} mode")
    nc, bn, stages, cm, cn = TILES[tile]
    cl = cm * cn
    if sms < cl:
        raise ValueError(f"tile class {tile} needs {cl} SMs, the card has {sms}")
    units = units_of(tile)
    if units * cl >= 2**31 or num_split * batch >= 2**31:
        raise ValueError(f"{units} units of {batch} matrices exceed the kernel's 32-bit unit index")
    plan = LaunchPlan(
        tile=tile, block_m=64 * nc, block_n=bn, stages=stages, cluster=cl, k_pad=k_pad,
        tiles=units * cl, grid=cl * min(sms // cl, units),
        smem_bytes=_smem_bytes(64 * nc, bn, stages), pairs=pairs,
    )
    if l2_bytes is not None and tile in WALK_TILES and units >= MIN_WAVES * (plan.grid // cl) \
            and pairs <= WALK_MAX_PAIRS \
            and 2 * num_split * k_pad * (64 * nc * cm + bn * cn) > l2_bytes:
        plan = dataclasses.replace(plan, window=lockstep_window(l2_bytes, plan, m, n))
    return plan


def lockstep_window(l2_bytes: int, plan: LaunchPlan, m: int, n: int) -> int:
    """The bounded-skew walk's window, in steps (one k tile of one pair),
    for ``plan``'s launch over m x n on a card with an L2 of ``l2_bytes``:
    :data:`WINDOW_SHARE` times the steps whose plane tiles the L2 holds, at
    the distinct bytes the clusters in flight read a step — the A tiles of
    a band's :data:`GROUP_M` cluster rows and the B tiles of the columns
    that the clusters cover — never below 1 nor above one unit's steps.
    On an H100 (50 MiB) at 16384^3 and ns = 9: 66 clusters over 8 rows and
    9 columns, 544 KiB a step, 94 steps of L2, a window of 282 steps.

    The L2 sets only the scale: the multiple is fitted, not derived.  At
    three L2s of steps the clusters that share a panel can be further apart
    than the L2 keeps it, yet the window won where windows under one L2
    lost (:data:`WINDOW_SHARE`); what it bounds is the pack's split into
    two paces, not each tile's reuse."""
    nc, bn, _, cm, cn = TILES[plan.tile]
    units_m = math.ceil(math.ceil(m / plan.block_m) / cm)
    units_n = math.ceil(math.ceil(n / bn) / cn)
    rows = min(GROUP_M, units_m)
    cols = min(units_n, math.ceil(plan.grid // plan.cluster / rows))
    step_bytes = (rows * cm * plan.block_m + cols * cn * bn) * BLOCK_K
    steps = plan.pairs * math.ceil(plan.k_pad / BLOCK_K)
    return max(1, min(steps, int(WINDOW_SHARE * l2_bytes / step_bytes)))


#: the totals fold's blocks: threads each, and at most this many per SM
#: in its grid-stride loop
FOLD_THREADS = 256
FOLD_BLOCKS_PER_SM = 8


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    vec: int  # consecutive elements a thread: 4 (16-byte accesses) or 1
    grid: int  # blocks of FOLD_THREADS
    threads: int


def fold_plan(elems: int, sms: int, aligned: bool) -> FoldPlan:
    """The totals fold's launch over ``elems`` output elements on ``sms``
    SMs: 4 elements a thread where ``elems`` is a multiple of 4 and both
    tensors are 16-byte ``aligned``, else 1; as many blocks as the
    elements need, at most :data:`FOLD_BLOCKS_PER_SM` an SM."""
    if elems < 1 or sms < 1:
        raise ValueError(f"no totals fold for {elems} elements on {sms} SMs")
    vec = 4 if aligned and elems % 4 == 0 else 1
    units = elems // vec
    return FoldPlan(vec=vec, grid=min(math.ceil(units / FOLD_THREADS), sms * FOLD_BLOCKS_PER_SM),
                    threads=FOLD_THREADS)


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


def _operands(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
              b_kmajor: bool, what: str):
    """The checks the kernel's wrappers share: ``(batched, da, db, bsz, m,
    n, k_in)`` with a 2-D call's planes given a batch axis of 1."""
    if da.device.type != "cuda" or db.device != da.device:
        raise ValueError(
            f"{what} needs CUDA tensors on one device, got {da.device} and {db.device}"
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
    return batched, da, db, bsz, m, n, k_in


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _host_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _card(device):
    """The card's SMs and L2 size in bytes."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.L2_cache_size


def _progress(plan: LaunchPlan, device) -> Optional[torch.Tensor]:
    """The bounded-skew walk's counters and slots (csrc/recombine.cu,
    struct Walk), zero, where ``plan`` takes the walk."""
    if not plan.window:
        return None
    return torch.zeros(2 + plan.grid // plan.cluster, dtype=torch.int32, device=device)


def _walked(plan: LaunchPlan, progress: Optional[torch.Tensor]) -> None:
    global LOCKSTEP_LAUNCHES, _last_walk
    if progress is not None:
        LOCKSTEP_LAUNCHES += 1
        native.counted(__name__, "LOCKSTEP_LAUNCHES")
        _last_walk = (plan.window, progress)


def last_walk() -> Optional[dict]:
    """The last launch that took the bounded-skew walk: its ``window``, how
    many times its producers had to wait for the slowest cluster
    (``waits``) and gave up waiting (``releases``); None before any.  Reads
    the counters from the card, so it waits for that launch."""
    if _last_walk is None:
        return None
    window, progress = _last_walk
    waits, releases = progress[:2].tolist()
    return {"window": window, "waits": waits, "releases": releases}


def recombine(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
              tile: Optional[int] = None, b_kmajor: bool = False) -> Triple:
    """The 2^ACC_SHIFT-scaled triple-f32 accumulator [m, n] of the digit
    planes ``da`` int8 [ns, m, k] and ``db`` int8 [ns, k, n]; or, in one
    launch, [B, m, n] of a batch ``da`` [ns, B, m, k], ``db`` [ns, B, k, n],
    matrix i the product of the planes of matrix i.  ``k`` is the true
    contraction length, which sets the group caps.  ``tile`` forces a tile
    class of :data:`TILES` (the launch plan chooses otherwise); every class
    gives the same bits.  The launch plan, told the card's L2 size,
    chooses the bounded-skew walk and its window; the walk gives the same
    bits as the free one.

    The kernel reads both operands k-contiguous (8-bit ``wgmma`` takes only
    K-major operands), k zero-padded to a multiple of :data:`K_ALIGN`.
    With ``b_kmajor`` the planes come so, as the engine's split and the
    distributed layer's gathers write them: ``da`` [ns, (B,) m, k_pad],
    ``db`` [ns, (B,) n, k_pad]; anything else raises, and nothing is
    copied.  Without it (the plain tests' planes) B's planes are
    transposed into a copy of ns*B*k*n bytes and A's padded where k is not
    a multiple."""
    global LAUNCHES
    batched, da, db, bsz, m, n, k_in = _operands(da, db, num_split, b, k, b_kmajor, "recombine")
    out = tuple(torch.empty((bsz, m, n), dtype=torch.float32, device=da.device) for _ in range(3))
    if min(bsz, m, n, k_in) == 0:
        out = tuple(o.zero_() for o in out)
        return out if batched else tuple(o[0] for o in out)
    sms, l2 = _card(da.device)
    n_groups, start, pi, pj, shi, slo = _schedule_arrays(num_split, k, b)
    plan = launch_plan(m, n, k_in, num_split, sms, tile, batch=bsz, groups=n_groups,
                       l2_bytes=l2)
    if not b_kmajor:
        da = _pad_k_major(da, plan.k_pad)
        db = _pad_k_major(db.transpose(2, 3), plan.k_pad)
    da, dbt = _k_major(da, plan.k_pad, "A"), _k_major(db, plan.k_pad, "B")
    ptr = _host_ptr
    progress = _progress(plan, da.device)
    with torch.cuda.device(da.device):
        code = native.lib().oz_recombine(
            da.data_ptr(), dbt.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            m, n, num_split, plan.k_pad, bsz, n_groups, ptr(start), ptr(pi), ptr(pj), ptr(shi),
            ptr(slo), plan.tile, plan.grid, plan.smem_bytes,
            None if progress is None else progress.data_ptr(), plan.window, _stream(da.device),
        )
    native.check(code, "recombine launch")
    LAUNCHES += 1
    LAUNCHES_BY_TILE[plan.tile] += 1
    native.counted(__name__, "LAUNCHES")
    native.counted(__name__, "LAUNCHES_BY_TILE", plan.tile)
    _walked(plan, progress)
    return out if batched else tuple(o[0] for o in out)


def group_totals(da: torch.Tensor, db: torch.Tensor, num_split: int, b: int, k: int,
                 totals: Optional[torch.Tensor] = None,
                 tile: Optional[int] = None) -> torch.Tensor:
    """The int32 group totals [G, m, n] (a batch: [G, B, m, n]) of the
    k-major planes ``da`` [ns, (B,) m, k_pad] and ``db`` [ns, (B,) n,
    k_pad], group g the exact sum of its pairs' products, in one launch of
    the kernel's totals mode: written to a new tensor or, with ``totals``
    (int32 of that shape, contiguous), added to it in place and returned.

    ``k`` is the GLOBAL contraction length: the schedule's caps bound the
    sum over all of it, so the totals of its k panels add without
    overflow.  The planes' own width k_pad (a multiple of :data:`K_ALIGN`,
    zero beyond the panel's k) sets the k tiles.  Planes in any other
    layout raise: nothing is copied.  ``tile`` as in :func:`recombine`."""
    global TOTALS_LAUNCHES
    batched, da, db, bsz, m, n, k_in = _operands(da, db, num_split, b, k, True,
                                                 "recombine (totals)")
    n_groups, start, pi, pj, _, _ = _schedule_arrays(num_split, k, b)
    shape = (n_groups, bsz, m, n)
    if totals is None:
        out = torch.empty(shape, dtype=torch.int32, device=da.device)
    else:
        want = (n_groups, bsz, m, n) if batched else (n_groups, m, n)
        if totals.dtype != torch.int32 or totals.device != da.device \
                or tuple(totals.shape) != want or not totals.is_contiguous() \
                or totals.data_ptr() % 8:
            raise ValueError(f"totals must be contiguous int32 {list(want)} on {da.device}, got "
                             f"{totals.dtype} {tuple(totals.shape)} on {totals.device}")
        out = totals.view(shape)
    if min(bsz, m, n) == 0:
        return out.zero_() if totals is None else totals
    sms, l2 = _card(da.device)
    plan = launch_plan(m, n, k_in, num_split, sms, tile, batch=bsz, totals=True, l2_bytes=l2)
    da, dbt = _k_major(da, plan.k_pad, "A"), _k_major(db, plan.k_pad, "B")
    ptr = _host_ptr
    progress = _progress(plan, da.device)
    with torch.cuda.device(da.device):
        code = native.lib().oz_recombine_totals(
            da.data_ptr(), dbt.data_ptr(), out.data_ptr(), int(totals is not None), m, n,
            num_split, plan.k_pad, bsz, n_groups, ptr(start), ptr(pi), ptr(pj), plan.tile,
            plan.grid, plan.smem_bytes, None if progress is None else progress.data_ptr(),
            plan.window, _stream(da.device),
        )
    native.check(code, "recombine (totals) launch")
    TOTALS_LAUNCHES += 1
    native.counted(__name__, "TOTALS_LAUNCHES")
    _walked(plan, progress)
    return out if batched else out.view(n_groups, m, n)


def fold_totals(totals: torch.Tensor, num_split: int, k: int, b: int) -> Triple:
    """The triple-f32 accumulator of int32 group totals [G, ...] (the
    schedule of ``group_schedule(num_split, k, b)``), in one launch: three
    float32 planes of ``totals.shape[1:]``, each the bits of
    :func:`.recombine.fold_group_totals` on the same totals."""
    global FOLD_LAUNCHES
    n_groups, _, _, _, shi, slo = _schedule_arrays(num_split, k, b)
    if totals.device.type != "cuda" or totals.dtype != torch.int32 or totals.dim() < 2 \
            or totals.shape[0] != n_groups or not totals.is_contiguous():
        raise ValueError(f"totals must be contiguous int32 [{n_groups}, ...] on a CUDA device, "
                         f"got {totals.dtype} {tuple(totals.shape)} on {totals.device}")
    out = torch.empty((3,) + tuple(totals.shape[1:]), dtype=torch.float32, device=totals.device)
    elems = totals[0].numel()
    if elems == 0:
        return tuple(out.unbind(0))
    plan = fold_plan(elems, torch.cuda.get_device_properties(totals.device).multi_processor_count,
                     aligned=totals.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(totals.device):
        code = native.lib().oz_totals_fold(
            totals.data_ptr(), out.data_ptr(), elems, n_groups, _host_ptr(shi), _host_ptr(slo),
            plan.vec, plan.grid, plan.threads, _stream(totals.device))
    native.check(code, "totals fold launch")
    FOLD_LAUNCHES += 1
    native.counted(__name__, "FOLD_LAUNCHES")
    return tuple(out.unbind(0))
