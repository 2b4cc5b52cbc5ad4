"""Wrapper of the CUDA epilogue and complex-fold kernels (csrc/epilogue.cu).

They replace plain XLA in the JAX package, which fuses the eager steps of
``ozimmu_tpu/core/gemm.py::_epilogue_SE`` and ``::_zfold_passes`` under
``jax.jit``.  Their plain PyTorch versions are
:func:`ozimmu_tpu_torch.core.gemm._epilogue_block` and ``::_zfold_block``;
each kernel equals its plain version bit for bit.  The wrappers take CUDA
tensors only and raise on anything else — there is no fallback.

The complex fold runs a plan built here in plain Python (:func:`zfold_plan`):
the aligned adds of ``_zfold_block`` in its order, each a step with a source,
a target and a scalar.  :func:`zfold_plain` interprets the same plan in
torch, so the CPU tests hold the plan against ``_zfold_block`` and against
the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from .. import native
from ..core.gemm import _EMPTY_EXP, ZGEMM_PASSES
from . import tf32x3
from .pack import aligned_add, pack_f64, unpack_f64

#: launches of the epilogue kernel (:func:`epilogue`) since the process
#: started (or since a caller last reset it)
LAUNCHES = 0
#: launches of the complex-fold kernel (:func:`zfold`), likewise
ZFOLD_LAUNCHES = 0

#: threads of a block (csrc/epilogue.cu, THREADS)
THREADS = 256
#: blocks of the grid-stride kernels per SM
BLOCKS_PER_SM = 8
#: the fold's sources beside the passes 0-3: c's real and imaginary parts
C_RE, C_IM = 4, 5
#: the most steps of a fold: four of beta * c, two per pass
MAX_STEPS = 12


def launch_grid(elements: int, sms: int) -> int:
    """Blocks of one launch over ``elements`` outputs on ``sms`` SMs: one
    thread per element, at most :data:`BLOCKS_PER_SM` blocks per SM
    (grid-stride beyond)."""
    if elements < 1 or sms < 1:
        raise ValueError(f"no epilogue launch for {elements} elements on {sms} SMs")
    return min(math.ceil(elements / THREADS), sms * BLOCKS_PER_SM)


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
    ``_zfold_block``): the (re, im) float64 planes."""
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


def _triples(SEs, what: str):
    """The contiguous f32 planes and int32 exponents of (S, E) pairs on
    one CUDA device, all [m, n]; raises on anything else."""
    E0 = SEs[0][1]
    if E0.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {E0.device}")
    if E0.dim() != 2:
        raise ValueError(f"{what} needs 2-D [m, n] planes, got {tuple(E0.shape)}")
    out = []
    for S, E in SEs:
        if len(S) != 3 or any(s.dtype != torch.float32 for s in S) or E.dtype != torch.int32:
            raise ValueError(f"{what} needs three float32 planes and int32 exponents")
        if any(x.shape != E0.shape or x.device != E0.device for x in (*S, E)):
            raise ValueError(f"{what}: planes of one shape on one device, got "
                             f"{[tuple(x.shape) for x in (*S, E)]}")
        out.append((tuple(s.contiguous() for s in S), E.contiguous()))
    return out


def _c_part(c: Optional[torch.Tensor], shape, device, what: str):
    if c is None:
        return None
    if c.dtype != torch.float64 or tuple(c.shape) != tuple(shape) or c.device != device:
        raise ValueError(f"{what}: c must be float64 {list(shape)} on {device}, got {c.dtype} "
                         f"{tuple(c.shape)} on {c.device}")
    return c


def _output(out: Optional[torch.Tensor], shape, device, what: str) -> torch.Tensor:
    """A float64 output [m, n] written through its row stride (its rows
    contiguous), new where ``out`` is None."""
    if out is None:
        return torch.empty(shape, dtype=torch.float64, device=device)
    if out.dtype != torch.float64 or tuple(out.shape) != tuple(shape) or out.device != device:
        raise ValueError(f"{what}: out must be float64 {list(shape)} on {device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if shape[1] > 1 and out.stride(1) != 1:
        raise ValueError(f"{what}: the rows of out must be contiguous, got strides {out.stride()}")
    return out


def _row_stride(x: torch.Tensor) -> int:
    return x.stride(0) if x.shape[0] > 1 else x.shape[1]


def epilogue(S, E: torch.Tensor, alpha: float, beta: float, c: Optional[torch.Tensor] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * (S * 2^E) + beta * c`` rounded to float64 once, for the
    triple S (three float32 [m, n]) and E (int32 [m, n]) on a CUDA device,
    in one launch.  ``c`` (float64 [m, n], any strides) is read only where
    beta != 0; the result goes to ``out`` (float64 [m, n], rows contiguous,
    e.g. a column panel of a wider output) or to a new tensor."""
    global LAUNCHES
    ((S, E),) = _triples([(S, E)], "epilogue")
    m, n = E.shape
    alpha, beta = float(alpha), float(beta)
    if beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        c = _c_part(c, (m, n), E.device, "epilogue")
    out = _output(out, (m, n), E.device, "epilogue")
    if m * n == 0:
        return out
    at, ae = tf32x3.from_f64_host(alpha) if alpha != 1.0 else ((0.0, 0.0, 0.0), 0)
    bt, be = tf32x3.from_f64_host(beta) if beta not in (0.0, 1.0) else ((0.0, 0.0, 0.0), 0)
    flags = int(alpha != 1.0) | int(beta != 0.0) << 1 | int(beta != 1.0) << 2
    c_ptr, c_rs, c_cs = (c.data_ptr(), c.stride(0), c.stride(1)) if beta != 0.0 else (None, 0, 0)
    grid = launch_grid(m * n, torch.cuda.get_device_properties(E.device).multi_processor_count)
    with torch.cuda.device(E.device):
        stream = torch.cuda.current_stream(E.device).cuda_stream
        code = native.lib().oz_epilogue(
            S[0].data_ptr(), S[1].data_ptr(), S[2].data_ptr(), E.data_ptr(), m, n, *at, ae, *bt,
            be, flags, c_ptr, c_rs, c_cs, out.data_ptr(), _row_stride(out), grid, stream,
        )
    native.check(code, "epilogue launch")
    LAUNCHES += 1
    return out


def zfold(SEs: Sequence, alpha: complex, beta: complex, c_re: Optional[torch.Tensor] = None,
          c_im: Optional[torch.Tensor] = None, out=None):
    """The complex fold of ``core.gemm._zfold_block`` in one launch: the
    four (S, E) pass results of :data:`ZGEMM_PASSES` (each [m, n] on a
    CUDA device) and c's parts (float64 [m, n], any strides, read only
    where beta != 0; a part that is None reads as zero) into the (re, im)
    float64 planes, new or ``out`` (a pair, rows contiguous)."""
    global ZFOLD_LAUNCHES
    if len(SEs) != len(ZGEMM_PASSES):
        raise ValueError(f"zfold takes {len(ZGEMM_PASSES)} pass results, got {len(SEs)}")
    SEs = _triples(SEs, "zfold")
    E0 = SEs[0][1]
    m, n = E0.shape
    plan = zfold_plan(alpha, beta)
    reads_c = plan.init_from_c or any(st.src >= C_RE for st in plan.steps)
    parts = [_c_part(x, (m, n), E0.device, "zfold") if reads_c else None for x in (c_re, c_im)]
    out = out if out is not None else (None, None)
    out_re, out_im = (_output(o, (m, n), E0.device, "zfold") for o in out)
    if m * n == 0:
        return out_re, out_im
    k = len(plan.steps)
    s_ptrs = (ctypes.c_void_p * 12)(*(s.data_ptr() for S, _ in SEs for s in S))
    e_ptrs = (ctypes.c_void_p * 4)(*(E.data_ptr() for _, E in SEs))
    c_strides = (ctypes.c_int64 * 4)(*(v for x in parts for v in (
        (x.stride(0), x.stride(1)) if x is not None else (0, 0))))
    src = (ctypes.c_int * MAX_STEPS)(*(st.src for st in plan.steps))
    dst = (ctypes.c_int * MAX_STEPS)(*(st.dst for st in plan.steps))
    t = (ctypes.c_float * (3 * MAX_STEPS))(*(v for st in plan.steps for v in st.triple))
    te = (ctypes.c_int * MAX_STEPS)(*(st.exp for st in plan.steps))
    grid = launch_grid(m * n, torch.cuda.get_device_properties(E0.device).multi_processor_count)
    with torch.cuda.device(E0.device):
        stream = torch.cuda.current_stream(E0.device).cuda_stream
        code = native.lib().oz_zfold(
            s_ptrs, e_ptrs, m, n, *(x.data_ptr() if x is not None else None for x in parts),
            c_strides, out_re.data_ptr(), out_im.data_ptr(), _row_stride(out_re),
            _row_stride(out_im), k, int(plan.init_from_c), src, dst, t, te, grid, stream,
        )
    native.check(code, "zfold launch")
    ZFOLD_LAUNCHES += 1
    return out_re, out_im
