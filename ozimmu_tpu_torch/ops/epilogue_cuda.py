"""Wrapper of the CUDA epilogue and complex-fold kernels (csrc/epilogue.cu).

They replace plain XLA in the JAX package, which fuses the eager steps of
``ozimmu_tpu/core/gemm.py::_epilogue_SE`` and ``::_zfold_passes`` under
``jax.jit``.  Their plain PyTorch versions are
:func:`ozimmu_tpu_torch.core.gemm._epilogue_block` and ``::_zfold_block``;
each kernel equals its plain version bit for bit.  The wrappers take CUDA
tensors only and raise on anything else — there is no fallback.

The exponents come as :class:`~ozimmu_tpu_torch.core.gemm.Exponents`
(``pa``, ``pb``, ``shift``: the kernel forms ``pa[r] + pb[c] - shift``, no
plane is built) or, for the epilogue, as a plane E (the sgemm demotion's
unpacked result has no row and column parts).

Everything a launch's shape decides is plain Python here:
:func:`launch_plan` (the 2-D grid, the vector body and the one-column
tail), :func:`fma_floors` (the bounds of the FMA route for a scalar) and
:func:`zfold_plan` (the fold's aligned adds in ``_zfold_block``'s order, each
a step with a source, a target and a scalar), which :func:`zfold_plain`
interprets in torch, so that the CPU tests hold the plan against
``_zfold_block`` and against the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from .. import native
from ..core.gemm import _EMPTY_EXP, ZGEMM_PASSES, Exponents, _as_plane
from . import tf32x3
from .pack import aligned_add, pack_f64, unpack_f64

#: launches of the epilogue kernel (:func:`epilogue`) since the process
#: started (or since a caller last reset it)
LAUNCHES = 0
#: launches of the complex-fold kernel (:func:`zfold`), likewise
ZFOLD_LAUNCHES = 0

#: threads of a block (csrc/epilogue.cu, THREADS)
THREADS = 256
#: columns of a thread's vector step (csrc/epilogue.cu, VEC): 16-byte loads
#: of f32 and int32, two 16-byte stores of f64
VEC = 4
#: resident blocks of 256 threads on an SM, and the waves of them a launch
#: aims at: rows are given to threads in bands until the grid has that many
BLOCKS_PER_SM = 8
WAVES = 2
#: the most rows one thread takes (the band's height over the block's)
MAX_ROWS_PER_THREAD = 64
#: a launch's row blocks go over the grid's y axis, and z beyond 65535
GRID_Y = 65535
#: the fold's sources beside the passes 0-3: c's real and imaginary parts
C_RE, C_IM = 4, 5
#: the most steps of a fold: four of beta * c, two per pass
MAX_STEPS = 12
#: the least exponent sum of a TwoProd's factors at which Dekker's and the
#: FMA's are both exact (-103 for f32), with three binades to spare
FMA_EXPONENT_SUM = -100


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch of either kernel over ``batch`` matrices of ``m`` x ``n``.

    Columns ``[0, n_body)`` of every row go in steps of :data:`VEC`, the
    rest one at a time; a block of ``block`` = (tx, ty) threads takes
    ``band`` rows of one matrix (``bands`` blocks a matrix, ``blocks`` in
    all, laid over ``grid`` = (gx, gy, gz), the x axis across the columns)."""

    n_body: int
    block: Tuple[int, int]
    band: int
    bands: int
    blocks: int
    grid: Tuple[int, int, int]

    def ints(self) -> Tuple[int, ...]:
        """The eight ints of the C interface (csrc/epilogue.cu, ``plan``)."""
        return (self.band, self.bands, self.blocks, *self.block, *self.grid)


def launch_plan(batch: int, m: int, n: int, sms: int, vector: bool) -> LaunchPlan:
    """The launch over ``batch`` matrices of ``m`` x ``n`` outputs on ``sms``
    SMs.  ``vector``: rows may go in vectors of :data:`VEC` (the epilogue,
    where every plane it reads by rows, S and pb or E, starts 16-byte
    aligned); with ``n`` a multiple of VEC too, every row is a vector body;
    else (odd n, a misaligned pointer, the fold) every column goes one at a
    time.  A block is 256 threads, as many
    across the columns as a row has steps (a power of two from 32), the
    rest down the rows; each thread takes rows until the grid holds
    :data:`WAVES` waves of :data:`BLOCKS_PER_SM` blocks."""
    if batch < 1 or m < 1 or n < 1 or sms < 1:
        raise ValueError(f"no epilogue launch for {batch} x {m} x {n} on {sms} SMs")
    n_body = n if vector and n % VEC == 0 else 0
    steps = n_body // VEC + (n - n_body)
    tx = min(THREADS, max(32, 1 << (steps - 1).bit_length()))
    ty = THREADS // tx
    gx = math.ceil(steps / tx)
    target = sms * BLOCKS_PER_SM * WAVES
    per_thread = max(1, min(MAX_ROWS_PER_THREAD, gx * batch * m // (ty * target)))
    band = min(ty * per_thread, m)
    bands = math.ceil(m / band)
    blocks = batch * bands
    gy = min(blocks, GRID_Y)
    return LaunchPlan(n_body=n_body, block=(tx, ty), band=band, bands=bands, blocks=blocks,
                      grid=(gx, gy, math.ceil(blocks / gy)))


def fma_floors(triple: Tuple[float, float, float]) -> Tuple[float, float]:
    """The least nonzero ``|x0|`` and ``|x1|`` for which ``tf32x3.mul(x,
    triple)`` may take the FMA TwoProd (csrc/tf32x3.cuh, mul_fma_exact):
    each of its products x0 * y0, x0 * y1 and x1 * y0 keeps its factors'
    exponents summing to :data:`FMA_EXPONENT_SUM` or more.  ``triple`` is
    a scalar of :func:`tf32x3.from_f64_host`; zero admits any x."""
    y0, y1, _ = triple
    if y0 == 0.0:
        return 0.0, 0.0
    exp = lambda v: math.frexp(v)[1] - 1  # noqa: E731  floor(log2|v|)
    floor1 = 2.0 ** (FMA_EXPONENT_SUM - exp(y0))
    floor0 = floor1 if y1 == 0.0 else max(floor1, 2.0 ** (FMA_EXPONENT_SUM - exp(y1)))
    return floor0, floor1


def _scalar(v: float) -> Tuple[Tuple[float, ...], int]:
    """The five floats of a kernel scalar (the exact triple of ``v``, then
    its :func:`fma_floors`) and its exponent."""
    t, e = tf32x3.from_f64_host(v)
    return (*t, *fma_floors(t)), e


@dataclasses.dataclass(frozen=True)
class ZfoldStep:
    src: int  # 0-3: the pass of ZGEMM_PASSES; C_RE, C_IM: a part of c
    dst: int  # 0: the real accumulator, 1: the imaginary one
    triple: Tuple[float, float, float]  # the scalar factor, exact (tf32x3.from_f64_host)
    exp: int


@dataclasses.dataclass(frozen=True)
class ZfoldPlan:
    init_from_c: bool  # the accumulators start as c (beta == 1); else empty
    steps: Tuple[ZfoldStep, ...]


def zfold_plan(alpha: complex, beta: complex) -> ZfoldPlan:
    """The aligned adds of ``core.gemm._zfold_block`` in its order: c
    pre-scaled by beta (where beta is neither 0 nor 1: c_re folded by
    beta, c_im by i * beta), then each pass of :data:`ZGEMM_PASSES` folded
    by +alpha (re * re), -alpha (im * im) or i * alpha (the cross terms),
    the real target before the imaginary one; a zero factor adds nothing."""
    alpha, beta = complex(alpha), complex(beta)
    steps = []

    def fold(src: int, fold_re: float, fold_im: float) -> None:
        for dst, f in ((0, fold_re), (1, fold_im)):
            if f != 0.0:
                t, e = tf32x3.from_f64_host(f)
                steps.append(ZfoldStep(src, dst, t, e))

    if beta != 0 and beta != 1:
        fold(C_RE, beta.real, beta.imag)
        fold(C_IM, -beta.imag, beta.real)
    for p, (ap, bp) in enumerate(ZGEMM_PASSES):
        if ap == 0 and bp == 0:
            f = alpha
        elif ap == 1 and bp == 1:
            f = -alpha
        else:
            f = complex(-alpha.imag, alpha.real)
        fold(p, f.real, f.imag)
    return ZfoldPlan(init_from_c=beta == 1, steps=tuple(steps))


def zfold_plain(SEs, plan: ZfoldPlan, c_re=None, c_im=None):
    """``plan`` run in torch on the four (S, E) pass results and c's parts
    (a part that is None reads as the empty accumulator, as in
    ``_zfold_block``; a pass's exponents may be a plane or
    :class:`Exponents` [m, n]): the (re, im) float64 planes."""
    SEs = [(S, _as_plane(E)) for S, E in SEs]
    E0 = SEs[0][1]
    shape, dev = E0.shape, E0.device

    def empty():
        return (tf32x3.zeros(shape, device=dev),
                torch.full(shape, _EMPTY_EXP, dtype=torch.int32, device=dev))

    def source(src: int):
        if src < C_RE:
            return SEs[src]
        part = (c_re, c_im)[src - C_RE]
        return empty() if part is None else unpack_f64(part)

    acc = [source(C_RE + d) if plan.init_from_c else empty() for d in (0, 1)]
    for st in plan.steps:
        S, E = source(st.src)
        ft = tuple(torch.full((), x, dtype=torch.float32, device=dev) for x in st.triple)
        acc[st.dst] = aligned_add(*acc[st.dst], tf32x3.mul(S, ft), E + st.exp)
    return pack_f64(*acc[0]), pack_f64(*acc[1])


def _slot(step: ZfoldStep) -> int:
    """The kernel's slot of a fold step: 0-3 for c_re and c_im (each to re,
    then im), 4 + 2p and 5 + 2p for pass p."""
    src = step.src - C_RE if step.src >= C_RE else 2 + step.src
    return 2 * src + step.dst


def _aligned16(*xs: torch.Tensor) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def _wide_rows(x: torch.Tensor, rows_stride: int) -> bool:
    """Whether the kernel may read or write ``x``'s rows two doubles at a
    time: contiguous columns, 16-byte aligned at every row's start."""
    return (x.shape[1] < 2 or x.stride(1) == 1) and x.data_ptr() % 16 == 0 \
        and rows_stride % 2 == 0


def _device(x: torch.Tensor, what: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    return x.device


def _triple_rows(S, rows: int, n: int, device, what: str):
    """The three float32 planes of a triple as contiguous [rows, n] (a
    batch [B, m, n] by its rows)."""
    if len(S) != 3 or any(s.dtype != torch.float32 or s.device != device for s in S):
        raise ValueError(f"{what} needs three float32 planes on {device}")
    if any(s.numel() != rows * n or s.shape[-1] != n for s in S):
        raise ValueError(f"{what}: S planes of {rows} x {n} elements, got "
                         f"{[tuple(s.shape) for s in S]}")
    return tuple(s.reshape(rows, n).contiguous() for s in S)


def _parts(E: Exponents, what: str):
    """(batch, rows, n, pa [batch * m], pb [batch, n]) of the exponents'
    parts, int32 and contiguous."""
    pa, pb = E.pa, E.pb
    if pa.dtype != torch.int32 or pb.dtype != torch.int32 or pa.device != pb.device:
        raise ValueError(f"{what} needs int32 pa and pb on one device")
    if pb.dim() not in (1, 2) or pa.dim() != pb.dim() \
            or (pb.dim() == 2 and pa.shape[0] != pb.shape[0]):
        raise ValueError(f"{what}: pa [m] and pb [n], or pa [B, m] and pb [B, n], got "
                         f"{tuple(pa.shape)} and {tuple(pb.shape)}")
    batch = pb.shape[0] if pb.dim() == 2 else 1
    return batch, pa.numel(), pb.shape[-1], pa.contiguous().view(-1), pb.contiguous()


def _c_part(c: Optional[torch.Tensor], rows: int, n: int, device, what: str):
    """c (float64 [rows, n], or a batch of them) as [rows, n], any strides."""
    if c is None:
        return None
    if c.dtype != torch.float64 or c.numel() != rows * n or c.shape[-1] != n or c.device != device:
        raise ValueError(f"{what}: c must be float64 of {rows} x {n} on {device}, got {c.dtype} "
                         f"{tuple(c.shape)} on {c.device}")
    return c.reshape(rows, n)


def _output(out: Optional[torch.Tensor], shape, device, what: str) -> torch.Tensor:
    """A float64 output of ``shape`` written through its row stride (its
    rows contiguous), new where ``out`` is None."""
    if out is None:
        return torch.empty(shape, dtype=torch.float64, device=device)
    if out.dtype != torch.float64 or tuple(out.shape) != tuple(shape) or out.device != device:
        raise ValueError(f"{what}: out must be float64 {list(shape)} on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if shape[-1] > 1 and out.stride(-1) != 1:
        raise ValueError(f"{what}: the rows of out must be contiguous, got strides {out.stride()}")
    return out


def _complex_output(out: torch.Tensor, shape, device, what: str) -> torch.Tensor:
    """A complex128 output of ``shape``, rows contiguous and 16-byte
    aligned, that the fold writes interleaved through its row stride."""
    if out.dtype != torch.complex128 or tuple(out.shape) != tuple(shape) or out.device != device:
        raise ValueError(f"{what}: out must be complex128 {list(shape)} on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if shape[-1] > 1 and out.stride(-1) != 1:
        raise ValueError(f"{what}: the rows of out must be contiguous, got strides {out.stride()}")
    if out.data_ptr() % 16:
        raise ValueError(f"{what}: out must be 16-byte aligned")
    return out


def _pair(c_re: Optional[torch.Tensor], c_im: Optional[torch.Tensor]) -> bool:
    """Whether c's parts are the (re, im) views of one complex128 array with
    contiguous rows, 16-byte aligned: each element one 16-byte load."""
    return (c_re is not None and c_im is not None
            and c_im.data_ptr() == c_re.data_ptr() + 8 and c_re.stride() == c_im.stride()
            and (c_re.shape[1] < 2 or c_re.stride(1) == 2)
            and c_re.data_ptr() % 16 == 0 and _row_stride(c_re) % 2 == 0)


def _rows_view(out: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    return out if out.dim() == 2 else out.view(rows, n)


def _row_stride(x: torch.Tensor) -> int:
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def epilogue(S, E, alpha: float, beta: float, c: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * (S * 2^E) + beta * c`` rounded to float64 once, in one
    launch, for the triple S (three float32 [m, n], or a batch [B, m, n])
    on a CUDA device.  ``E`` is :class:`Exponents` (pa [m], pb [n], or a
    batch's [B, m] and [B, n]; no plane is built) or an int32 plane of S's
    shape.  ``c`` (float64 of S's shape, any strides) is read only where
    beta != 0; the result goes to ``out`` (float64 of S's shape, rows
    contiguous, e.g. a column panel of a wider output) or to a new
    tensor."""
    global LAUNCHES
    dev = _device(S[0], "epilogue")
    shape = tuple(S[0].shape)
    if isinstance(E, Exponents):
        batch, rows, n, pa, pb = _parts(E, "epilogue")
        plane, planes = None, (pb,)
    else:
        if E.dtype != torch.int32 or tuple(E.shape) != shape:
            raise ValueError(f"epilogue: E must be int32 {list(shape)}, got {E.dtype} "
                             f"{tuple(E.shape)}")
        n = shape[-1]
        batch, rows = 1, E.numel() // max(1, n)
        plane = E.reshape(rows, n).contiguous()
        pa = pb = None
        planes = (plane,)
    if _device(planes[0], "epilogue") != dev:
        raise ValueError(f"epilogue: S on {dev}, the exponents on {planes[0].device}")
    S = _triple_rows(S, rows, n, dev, "epilogue")
    alpha, beta = float(alpha), float(beta)
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    c = _c_part(c, rows, n, dev, "epilogue") if beta != 0.0 else None
    out = _output(out, shape, dev, "epilogue")
    if rows * n == 0:
        return out
    o = _rows_view(out, rows, n)
    plan = launch_plan(batch, rows // batch, n, _sms(dev), _aligned16(*S, *planes))
    vec = plan.n_body > 0
    at, ae = _scalar(alpha) if alpha != 1.0 else ((0.0,) * 5, 0)
    bt, be = _scalar(beta) if beta not in (0.0, 1.0) else ((0.0,) * 5, 0)
    c_rs = _row_stride(c) if c is not None else 0
    flags = (int(alpha != 1.0) | int(beta != 0.0) << 1 | int(beta != 1.0) << 2
             | int(plane is not None) << 3
             | int(vec and c is not None and _wide_rows(c, c_rs)) << 4
             | int(vec and _wide_rows(o, _row_stride(o))) << 5)
    f5 = ctypes.c_float * 5
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = native.lib().oz_epilogue(
            (ctypes.c_void_p * 3)(*(s.data_ptr() for s in S)),
            plane.data_ptr() if plane is not None else None,
            pa.data_ptr() if pa is not None else None,
            pb.data_ptr() if pb is not None else None,
            E.shift if plane is None else 0, rows // batch, n, plan.n_body,
            (ctypes.c_int * 8)(*plan.ints()), f5(*at), ae, f5(*bt), be, flags,
            c.data_ptr() if c is not None else None, c_rs, c.stride(1) if c is not None else 0,
            o.data_ptr(), _row_stride(o), stream,
        )
    native.check(code, "epilogue launch")
    LAUNCHES += 1
    native.counted(__name__, "LAUNCHES")
    return out


def zfold(SEs: Sequence, alpha: complex, beta: complex, c_re: Optional[torch.Tensor] = None,
          c_im: Optional[torch.Tensor] = None, out=None):
    """The complex fold of ``core.gemm._zfold_block`` in one launch: the
    four (S, :class:`Exponents`) pass results of :data:`ZGEMM_PASSES` (each
    S [m, n], or a batch's [B * m, n] rows with exponents pa [B, m], pb
    [B, n], on a CUDA device) and c's parts (float64 of S's shape, any
    strides, read only where beta != 0; a part that is None reads as zero)
    into the (re, im) float64 planes, new or ``out`` (a pair, rows
    contiguous).  Where ``out`` is a complex128 tensor of S's shape (rows
    contiguous; a window of a larger matrix, or c's own array), the fold
    writes it interleaved, (re, im) in one 16-byte store an element, and
    returns it; c's parts that are the (re, im) views of one complex128
    array are then read 16 bytes an element too.  The layout follows the
    type of ``out``: the two give the same bits."""
    global ZFOLD_LAUNCHES
    if len(SEs) != len(ZGEMM_PASSES):
        raise ValueError(f"zfold takes {len(ZGEMM_PASSES)} pass results, got {len(SEs)}")
    dev = _device(SEs[0][0][0], "zfold")
    shape = tuple(SEs[0][0][0].shape)
    if not all(isinstance(E, Exponents) for _, E in SEs):
        raise ValueError("zfold takes each pass's exponents as Exponents (pa, pb, shift)")
    parts = [_parts(E, "zfold") for _, E in SEs]
    batch, rows, n = parts[0][:3]
    if any(p[:3] != (batch, rows, n) for p in parts) or len({E.shift for _, E in SEs}) != 1:
        raise ValueError("zfold: the passes' exponents differ in shape or shift")
    if any(_device(p[4], "zfold") != dev for p in parts):
        raise ValueError(f"zfold: S on {dev}, exponents elsewhere")
    Ss = [_triple_rows(S, rows, n, dev, "zfold") for S, _ in SEs]
    plan = zfold_plan(alpha, beta)
    reads_c = plan.init_from_c or any(st.src >= C_RE for st in plan.steps)
    cs = [_c_part(x, rows, n, dev, "zfold") if reads_c else None for x in (c_re, c_im)]
    interleaved = isinstance(out, torch.Tensor)
    if interleaved:
        result = _complex_output(out, shape, dev, "zfold")
        flat = _rows_view(result, rows, n)
        o_ptrs = (flat.data_ptr(), flat.data_ptr() + 8)
        o_rs = (2 * _row_stride(flat),) * 2
    else:
        result = tuple(_output(o, shape, dev, "zfold") for o in (out or (None, None)))
        flat = [_rows_view(o, rows, n) for o in result]
        o_ptrs = tuple(o.data_ptr() for o in flat)
        o_rs = tuple(_row_stride(o) for o in flat)
    if rows * n == 0:
        return result
    launch = launch_plan(batch, rows // batch, n, _sms(dev), False)
    c_rs = [_row_stride(x) if x is not None else 0 for x in cs]
    slots = [_slot(st) for st in plan.steps]
    if slots != sorted(set(slots)):
        raise AssertionError(f"the fold's steps are out of the kernel's slot order: {slots}")
    t = [0.0] * (5 * MAX_STEPS)
    te = [0] * MAX_STEPS
    for k, st in zip(slots, plan.steps):
        t[5 * k:5 * k + 5] = (*st.triple, *fma_floors(st.triple))
        te[k] = st.exp
    ptrs = ctypes.c_void_p * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = native.lib().oz_zfold(
            (ctypes.c_void_p * 12)(*(s.data_ptr() for S in Ss for s in S)),
            ptrs(*(p[3].data_ptr() for p in parts)), ptrs(*(p[4].data_ptr() for p in parts)),
            SEs[0][1].shift, rows // batch, n, (ctypes.c_int * 8)(*launch.ints()),
            *(x.data_ptr() if x is not None else None for x in cs),
            (ctypes.c_int64 * 4)(*(v for x, rs in zip(cs, c_rs) for v in (
                (rs, x.stride(1)) if x is not None else (0, 0)))),
            *o_ptrs, *o_rs,
            int(plan.init_from_c) | int(interleaved) << 1 | int(interleaved and _pair(*cs)) << 2,
            sum(1 << k for k in slots), (ctypes.c_float * (5 * MAX_STEPS))(*t),
            (ctypes.c_int * MAX_STEPS)(*te), stream,
        )
    native.check(code, "zfold launch")
    ZFOLD_LAUNCHES += 1
    native.counted(__name__, "ZFOLD_LAUNCHES")
    return result
