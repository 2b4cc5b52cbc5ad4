"""Slice-pair scheduling and overflow-safe chunk-width rules.

Pure Python (host side), a copy of ``ozimmu_tpu.schedule`` except for the
default memory budget of :func:`auto_n_chunks`, which is read from the
device the operands live on.  It re-derives the reference's scheduling
semantics:

  - ``bits_per_int8(k)``: overflow-safe number of mantissa bits per int8
    slice so a length-``k`` int8·int8 dot product fits in int32
    (reference src/split.cu:520-536).
  - slice-pair schedule: all pairs ``(i, j)`` with ``1 <= i, j <= ns`` and
    ``i + j <= ns + 1``, emitted in ascending ``i + j`` (most significant
    partial products first) — reference src/config.cu:86-92.

Pairs with equal ``t = i + j`` share the same recombination weight
``2^(2 - b*t)``, so their int32 partial products can be summed in int32
before any floating-point work.  ``group_schedule`` chunks the schedule
into groups of equal ``t``, sub-chunked so the int32 accumulation provably
cannot overflow.  Both the plain recombination (ops/recombine.py) and the
CUDA kernel (csrc/recombine.cu) fold exactly these groups in exactly this
order, which is what keeps them bitwise equal.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import List, Tuple

import torch

from .utils.log import error

#: int32 magnitude budget for an accumulated dot product.
_INT32_BUDGET = 2**31 - 1

#: device bytes the engine holds per output element, besides the operands
#: and their digit planes: the triple-f32 accumulator (12), its exponent
#: plane (4), an int32 group total (4) and the packed f64 result (8).  The
#: JAX package's models count the same 28 B, and so does this one.  On a
#: CUDA device the engine holds less: the epilogue and the complex fold
#: are kernels (ops/epilogue_cuda.py) that read S, form each exponent from
#: the split's row and column scales (no exponent plane) and write the
#: result with no temporaries, and the recombine kernel keeps no int32
#: totals.
#: On the CPU the plain epilogue's eager passes hold temporaries beside
#: them, which take what the budget leaves (:func:`epilogue_block_bytes`).
BYTES_PER_OUTPUT_ELEMENT = 12 + 4 + 4 + 8

#: the least memory that the temporaries of one row block of the plain
#: (CPU) epilogue (core/gemm.py::_epilogue_block, _zfold_block: some 40
#: unfused elementwise torch passes) may take where the budget leaves
#: less: a block must give each pass enough work, or the host's launches
#: set the pace (1 GiB blocks made ZHPL 26-34 % slower when the plain
#: epilogue ran on an H100, PERF.md).  Not used on a CUDA device.
EPILOGUE_BLOCK_BYTES = 4 << 30


def bits_per_int8(k: int) -> int:
    """Mantissa bits stored per int8 slice for contraction length ``k``.

    ``b = min(7, (31 - ceil(log2 k)) / 2)`` so that
    ``k * (2^b - 1)^2 <= k * 2^(2b) <= 2^31`` — a single slice-pair dot
    product of length ``k`` cannot overflow int32
    (reference split.cu:520-536; decl ozimmu.hpp:100).
    """
    if k <= 0:
        return 0
    log2_k = max(0, math.ceil(math.log2(k))) if k > 1 else 0
    return max(0, min(7, (31 - log2_k) // 2))


def pair_schedule(num_split: int) -> List[Tuple[int, int]]:
    """All slice pairs ``(i, j)``, 1-indexed, ``i + j <= ns + 1``.

    Emitted in ascending ``t = i + j`` (reference config.cu:86-92), which
    fixes the deterministic accumulation order: most significant products
    first.  Length is ``ns * (ns + 1) / 2``.
    """
    if num_split < 1:
        raise ValueError(f"num_split must be >= 1, got {num_split}")
    pairs: List[Tuple[int, int]] = []
    for t in range(2, num_split + 2):
        for j in range(1, t):
            i = t - j
            if i > num_split or j > num_split:
                continue
            pairs.append((i, j))
    return pairs


@dataclasses.dataclass(frozen=True)
class PairGroup:
    """A chunk of slice pairs sharing one recombination weight.

    ``weight = 2^(2 - b * t)`` (derived from reference gemm.cu:393-402:
    the per-pair scale ``2^32 * 2^-(b(i+j-2) - 2(7-b)) * 2^-44`` with the
    low-bit placement of the b mantissa bits folded in).
    """

    t: int  # i + j for every pair in this group
    pairs: Tuple[Tuple[int, int], ...]

    def weight_log2(self, b: int) -> int:
        return 2 - b * self.t


def max_safe_pairs_per_group(k: int, b: int) -> int:
    """How many slice-pair dot products of length ``k`` with ``b``-bit
    digits may be accumulated in one int32 without overflow.

    Each pair contributes at most ``k * (2^b - 1)^2`` in magnitude.
    """
    if k <= 0 or b <= 0:
        return 1
    per_pair = k * (2**b - 1) ** 2
    return max(1, _INT32_BUDGET // per_pair)


def group_schedule(num_split: int, k: int, b: int | None = None) -> List[PairGroup]:
    """Group the pair schedule by ``t = i + j``, sub-chunked for int32 safety.

    Groups are emitted in ascending ``t``; within a ``t`` the pair order of
    :func:`pair_schedule` is preserved, so flattening the groups reproduces
    the reference's deterministic order exactly.
    """
    if b is None:
        b = bits_per_int8(k)
    cap = max_safe_pairs_per_group(k, b)
    groups: List[PairGroup] = []
    by_t: dict[int, List[Tuple[int, int]]] = {}
    for i, j in pair_schedule(num_split):
        by_t.setdefault(i + j, []).append((i, j))
    for t in sorted(by_t):
        chunk = by_t[t]
        for s in range(0, len(chunk), cap):
            groups.append(PairGroup(t=t, pairs=tuple(chunk[s : s + cap])))
    return groups


def schedule_flops(num_split: int, m: int, n: int, k: int, complex_: bool = False) -> int:
    """Int8 MAC ops issued per emulated GEMM (2*m*n*k per pair; x4 complex)."""
    num_pairs = num_split * (num_split + 1) // 2
    return 2 * m * n * k * num_pairs * (4 if complex_ else 1)


def effective_flops(m: int, n: int, k: int, complex_: bool = False) -> int:
    """FP64-equivalent FLOP count used for TFLOPS accounting
    (reference test/main_test.cu:140-141: ``2*m*n*k``, x4 for complex)."""
    return 2 * m * n * k * (4 if complex_ else 1)


def working_set_bytes(
    m: int, n: int, k: int, num_split: int, complex_: bool = False
) -> int:
    """Approximate device working set for one emulated GEMM (analogue of
    the reference's ``calculate_working_memory_size``, config.cu:121-146).
    PyTorch's caching allocator owns allocation; this is a planning and
    introspection helper.

    The plane term counts each operand's int8 planes once, which is what
    the engine allocates: its split writes them k-major, as recombine reads
    them, so B's planes are never copied into a transposed second layout.
    Padding k to a multiple of 16 adds at most 15 bytes per plane row,
    which the term leaves out (exact where k is a multiple of 16)."""
    factor = 2 if complex_ else 1
    slices = num_split * (m * k + k * n) * factor  # int8 planes
    exps = 4 * (m + n) * factor  # int32 row/col exponents
    acc = (3 * 4 + 4) * m * n * factor  # f32 triple + exponent
    c_io = 8 * m * n * factor  # packed result
    return slices + exps + acc + c_io


def working_set_bytes_chunked(
    m: int, n: int, k: int, num_split: int, n_chunks: int, complex_: bool = False
) -> int:
    """Peak device working set of the column-panel-chunked engine.

    The chunked engine (core.gemm._loop over column panels) keeps A's operand
    and int8 planes plus B's operand and the full output resident, and
    streams B's planes / int32 partials / triple-f32 accumulator one
    n-panel at a time — so those scale by 1/n_chunks.  Each panel is split
    where it lies in B (no contiguous copy of the column panel) straight
    into its k-major planes, counted once, as in :func:`working_set_bytes`
    (k padded to a multiple of 16 adds at most 15 bytes per plane row).
    """
    factor = 2 if complex_ else 1
    w = -(-n // n_chunks)
    resident = factor * (
        8 * m * k  # A operand (float64)
        + 8 * k * n  # B operand
        + 8 * m * n  # packed output
        + num_split * m * k  # A int8 digit planes
    )
    per_chunk = factor * (
        num_split * k * w  # B panel int8 digit planes
        + BYTES_PER_OUTPUT_ELEMENT * m * w
    )
    if complex_:
        # the 4-pass engine holds all four (S, E) pass results of the
        # current panel before folding
        per_chunk += 3 * (12 + 4) * m * w
    return resident + per_chunk


#: the cuts of the engine's replay (core/gemm.py::replays): a 2-D product
#: on a CUDA device in one column panel replays its kernel chain as one
#: captured CUDA graph where its int8 work (:func:`schedule_flops`) is at
#: most REPLAY_MAX_WORK, that of 2048^3 at ns = 9, and its entry
#: (:func:`replay_bytes`) at most REPLAY_MAX_BYTES.  On an H100 at 700 W
#: (tools/torch_replay_cut.py, PERF.md §6), replay against eager:
#: synchronised calls gained at every shape up to 4096^3; calls queued back
#: to back, where the eager host path hides behind the card and the replay
#: adds its copies, gained up to 2048^3 (time x 0.66) and lost from 2560^3
#: (x 1.04-1.05), and lost at 8192^2 x 64 and x 128 (x 1.15), whose entries
#: of 1.36 GB the bytes cut keeps out, where 4096^2 x 512 (0.41 GB) gained.
REPLAY_MAX_WORK = 45 * 2 * 2048**3
REPLAY_MAX_BYTES = 512 << 20

#: share of :func:`hbm_budget_bytes` that the captured chains may hold
#: together (:func:`replay_cache_bytes`)
REPLAY_BUDGET_SHARE = 1 / 12


def replay_bytes(m: int, n: int, k: int, num_split: int, complex_: bool = False,
                 c_parts: int = 0) -> int:
    """Device bytes that one captured chain holds: the static copies of
    A's and B's parts (8 B an element) and of the ``c_parts`` parts of c
    that it reads, the digit planes (ns B an element, k padded to 16) and
    row and column scales of every part, the triple of every pass (12 B an
    output element) and the output's parts (8 B).  About 55 MB a real
    1024^3 product at ns = 9."""
    parts, passes = (2, 4) if complex_ else (1, 1)
    kp = -(-k // 16) * 16
    per_part = 8 * (m * k + k * n) + num_split * (m + n) * kp + 4 * (m + n) + 8 * m * n
    return parts * per_part + 8 * m * n * c_parts + 12 * m * n * passes


#: share of the device's memory that auto-chunking plans to use; the rest
#: is headroom for the caching allocator's slack.
_BUDGET_SHARE = 0.6

#: processes that hold their data in this process's device memory, set
#: for the length of a call by :func:`shared_device`
_SHARERS = 1


@contextlib.contextmanager
def shared_device(count: int):
    """Inside the block the default budget of :func:`hbm_budget_bytes` is
    this process's share of the device: 1 / ``count`` of it.  Several rank
    processes of a mesh can share one card (over gloo) or the host's
    memory; each sizes its working sets and epilogue blocks from its
    share.  Process-wide, as the device memory it divides."""
    global _SHARERS
    saved, _SHARERS = _SHARERS, max(1, int(count))
    try:
        yield
    finally:
        _SHARERS = saved


def hbm_budget_bytes(device=None) -> int:
    """Memory budget for :func:`auto_n_chunks`.

    ``OZIMMU_HBM_BUDGET_MB`` overrides; otherwise a share of the total
    memory of ``device`` (a CUDA device's ``total_memory``, or the host's
    physical memory for the CPU), divided among the processes that share
    it (:func:`shared_device`)."""
    mb = os.environ.get("OZIMMU_HBM_BUDGET_MB")
    if mb:
        return int(mb) * (1 << 20)
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(total * _BUDGET_SHARE) // _SHARERS


def replay_cache_bytes(device) -> int:
    """Device bytes that the engine's captured chains (core/gemm.py) may
    hold together on ``device``: :data:`REPLAY_BUDGET_SHARE` of
    :func:`hbm_budget_bytes`, so it follows ``OZIMMU_HBM_BUDGET_MB`` and the
    processes that share the card.  4.0 GB of an 80 GB card's default
    budget, outside the share that auto-chunking plans with."""
    return int(hbm_budget_bytes(device) * REPLAY_BUDGET_SHARE)


def epilogue_block_bytes(device) -> int:
    """Bytes that the temporaries of one row block of the plain epilogue
    may take on ``device``: what :func:`hbm_budget_bytes` leaves beside
    what is allocated there now, and at least :data:`EPILOGUE_BLOCK_BYTES`.
    An output whose temporaries fit runs as one block, exactly as
    unblocked.  The engine runs the plain epilogue on the CPU only (on a
    CUDA device the kernel needs no blocks)."""
    device = torch.device(device)
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    return max(EPILOGUE_BLOCK_BYTES, hbm_budget_bytes(device) - held)


def auto_n_chunks(
    m: int, n: int, k: int, num_split: int, complex_: bool = False, device=None
) -> int:
    """Smallest column-panel count whose peak working set fits the memory
    budget of ``device`` (1 = unchunked).  Doubling sweep, capped at
    min(n, 64): beyond that the problem simply does not fit.  The cap is
    then reported through ``utils.log.error`` (m, n, k, ns, budget and
    working set) and returned; the allocator reports the out-of-memory
    error if there is one.
    """
    budget = hbm_budget_bytes(device)
    c = 1
    while (
        working_set_bytes_chunked(m, n, k, num_split, c, complex_) > budget
        and c < min(n, 64)
    ):
        c *= 2
    c = min(c, max(n, 1))
    need = working_set_bytes_chunked(m, n, k, num_split, c, complex_)
    if need > budget:
        error(
            f"auto_n_chunks: m={m} n={n} k={k} ns={num_split}"
            f"{' complex' if complex_ else ''}: working set {need} B at the cap of "
            f"{c} column panels exceeds the memory budget {budget} B"
        )
    return c
