"""Public GEMM API: mode dispatch, operand normalization, profiling.

Port of ``ozimmu_tpu.core.api``, the equivalent of ``mtk::ozimmu::gemm``
(reference src/gemm.cu:524-653): argument validation, per-mode dispatch
(int8 engine / AUTO selection / native f64 / f32 demotion), the staged
profiled path, the batched entry and warm-up.

Input/output convention: row-major logical matrices, as numpy float64 or
complex128 arrays or torch float64 or complex128 tensors (``a``, ``b`` and
``c`` of one container kind; complex if any of them is).  Numpy inputs
are placed on ``device`` (default: the handle's, ``"cuda"``) and the
result comes back as numpy; tensor inputs run on their own device and the
result is a tensor there.  ``op_a``/``op_b`` apply BLAS-style transposes
to the *logical* matrices: ``gemm(a, b, op_a="T")`` computes
``alpha * a.T @ b + beta * c``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from ..ops import tf32x3
from ..ops.mantissa_loss import auto_mode_select as _auto_mode_select_core
from ..ops.mantissa_loss import auto_mode_select_complex
from ..ops.pack import unpack_f64
from ..ops.recombine import acc_shift, padded_k, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import bits_per_int8
from ..types import ComputeMode, ComputeModeLike, ElementKind, Operation, OperationLike
from ..utils.env import env_flag
from ..utils.log import log
from ..utils.profiling import culip_timer, synchronize
from .gemm import (
    Exponents, _epilogue_SE, _k0_result, _zfold_passes, _zk0_result, _zpasses, _zsplit,
    gemm_f64, gemm_f64_batched, zgemm_f64, zgemm_f64_batched,
)
from .handle import Handle, default_handle

ArrayLike = Union[np.ndarray, torch.Tensor]


def _apply_op(x: torch.Tensor, op: Operation) -> torch.Tensor:
    if op is Operation.N:
        return x
    if op is Operation.C and x.is_complex():
        # a conj-bit view; materialised so that the planes' int64 views
        # read the conjugated bits (np.conj's, -0.0 included)
        return x.conj().T.resolve_conj()
    return x.T  # T, or C on real input (conjugation is the identity)


def _operand(x, name: str, is_np: bool, device) -> torch.Tensor:
    """``x`` as a float64 or complex128 tensor: numpy arrays are converted
    and placed on ``device``; tensors are checked and stay where they lie."""
    if is_np:
        if not isinstance(x, np.ndarray):
            raise TypeError(f"operand {name}: expected a numpy array like a, got {type(x)}")
        dt = np.complex128 if np.iscomplexobj(x) else np.float64
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dt)).to(device)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"operand {name}: expected a torch tensor like a, got {type(x)}")
    if x.dtype not in (torch.float64, torch.complex128):
        raise TypeError(f"operand {name}: expected float64 or complex128, got {x.dtype}")
    return x


def _operands(a, b, c, handle: Handle, device):
    """(is_np, a, b, c) with a, b, c tensors on one device (c may be None)."""
    is_np = isinstance(a, np.ndarray)
    dev = torch.device(device if device is not None else handle.device) if is_np else None
    at, bt = _operand(a, "a", is_np, dev), _operand(b, "b", is_np, dev)
    ct = _operand(c, "c", is_np, dev) if c is not None else None
    return is_np, at, bt, ct


def _planes(x: torch.Tensor):
    """Contiguous real and imaginary float64 planes of a complex tensor
    (``x.real`` / ``x.imag`` are stride-2 views, which the split kernel
    does not take)."""
    return x.real.contiguous(), x.imag.contiguous()


def _complex_result(re: torch.Tensor, im: torch.Tensor, is_np: bool):
    if is_np:
        # the JAX package's construction (signed zeros follow numpy's
        # complex arithmetic), so the numpy results match it bit for bit
        return re.cpu().numpy() + 1j * im.cpu().numpy()
    return torch.complex(re, im)


def _check_k_supported(k: int) -> None:
    if bits_per_int8(k) <= 0:
        raise ValueError(
            f"k={k} exceeds the int8 emulation bound (needs k*2^(2b) <= 2^31);"
            " shard or chunk the contraction"
        )


# ---------------------------------------------------------------------------
# demoted (sgemm) mode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_f32_matmul(device: torch.device):
    """f32 matmuls at full f32 precision (the JAX package uses
    ``Precision.HIGHEST``): TF32 / bf16 internal precision is switched off
    for ``device``'s matmul backend inside the block and the caller's
    setting is restored after it, so a global
    ``torch.set_float32_matmul_precision("high")`` does not leak in."""
    backend = torch.backends.cuda.matmul if device.type == "cuda" else torch.backends.mkldnn.matmul
    saved = backend.fp32_precision
    backend.fp32_precision = "ieee"
    try:
        yield
    finally:
        backend.fp32_precision = saved


def _f64_to_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 view of exact f64 bits, by the JAX package's own sequence
    (unpack, scale, ``t0 + t1 + t2``), so the demoted operands match it
    bit for bit."""
    t, E = unpack_f64(x)
    s = tf32x3.scale_pow2(t, E)
    return s[0] + s[1] + s[2]


def _sgemm_core(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-demoted GEMM (reference cublas_helper.cu:83-216 semantics):
    demote operands to f32, matmul in full f32, widen the result exactly.
    Takes [m, k] @ [k, n] or batches [B, m, k] @ [B, k, n]."""
    with _full_f32_matmul(a.device):
        c32 = torch.matmul(_f64_to_f32(a), _f64_to_f32(b))
    return c32.to(torch.float64)


def _csgemm_core(a_re, a_im, b_re, b_im, alpha: complex, beta: complex, c_re=None, c_im=None):
    """Complex f32-demoted GEMM (reference Cgemm demotion,
    cublas_helper.cu:123-125,190-216): demote the re/im planes to f32, run
    4 real f32 matmuls, apply alpha/beta in f32 (the reference passes
    cuComplex scalars to cublasCgemm), widen exactly."""
    a32r, a32i = _f64_to_f32(a_re), _f64_to_f32(a_im)
    b32r, b32i = _f64_to_f32(b_re), _f64_to_f32(b_im)
    with _full_f32_matmul(a_re.device):
        p_re = torch.matmul(a32r, b32r) - torch.matmul(a32i, b32i)
        p_im = torch.matmul(a32r, b32i) + torch.matmul(a32i, b32r)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    al_r, al_i = f32(alpha.real), f32(alpha.imag)
    o_re = al_r * p_re - al_i * p_im
    o_im = al_r * p_im + al_i * p_re
    if beta != 0 and c_re is not None:
        c32r, c32i = _f64_to_f32(c_re), _f64_to_f32(c_im)
        be_r, be_i = f32(beta.real), f32(beta.imag)
        o_re = o_re + be_r * c32r - be_i * c32i
        o_im = o_im + be_r * c32i + be_i * c32r
    return o_re.to(torch.float64), o_im.to(torch.float64)


# ---------------------------------------------------------------------------
# staged (profiled) int8 paths: the same steps as core.gemm's cores, each
# phase ended by a device synchronisation (reference labels
# gemm.cu:38-48,312,393,404).
# ---------------------------------------------------------------------------


def _gemm_staged(handle: Handle, a, b, num_split: int, alpha: float, beta: float, c):
    prof = handle.profiler
    dev = a.device
    k = a.shape[1]
    bb = bits_per_int8(k)
    kp = padded_k(k)
    with prof.phase("split_A", sync=dev):
        da, pa = split_f64(a, num_split, bb, kp)
    with prof.phase("split_B", sync=dev):
        db, pb = split_f64_cols(b, num_split, bb, kp)
    with prof.phase("int8tc+accumulate_in_f64", sync=dev):
        S = recombine(da, db, num_split, bb, k, b_kmajor=True)
    with prof.phase("copy_result", sync=dev):
        E = Exponents(pa, pb, acc_shift(num_split, bb))
        out = _epilogue_SE(S, E, float(alpha), float(beta), c)
    return out


def _zgemm_staged(handle: Handle, a_re, a_im, b_re, b_im, num_split: int,
                  alpha: complex, beta: complex, c_re, c_im):
    """Phase-profiled 4-pass complex engine (the reference profiles the
    complex engine with the real one's labels, gemm.cu:412-521)."""
    prof = handle.profiler
    dev = a_re.device
    m, k = a_re.shape
    n = b_re.shape[1]
    bb = bits_per_int8(k)
    kp = padded_k(k)
    with prof.phase("split_A", sync=dev):
        a_planes = _zsplit(a_re, a_im, num_split, bb, kp, cols=False)
    with prof.phase("split_B", sync=dev):
        b_planes = _zsplit(b_re, b_im, num_split, bb, kp, cols=True)
    with prof.phase("int8tc+accumulate_in_f64", sync=dev):
        SEs = _zpasses(a_planes, b_planes, num_split, bb, k, b_kmajor=True)
    with prof.phase("copy_result", sync=dev):
        out = _zfold_passes(SEs, m, n, alpha, beta, c_re, c_im, dev)
    return out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def gemm(
    a: ArrayLike,
    b: ArrayLike,
    *,
    mode: Optional[ComputeModeLike] = None,
    op_a: OperationLike = Operation.N,
    op_b: OperationLike = Operation.N,
    alpha=1.0,
    beta=0.0,
    c: Optional[ArrayLike] = None,
    handle: Optional[Handle] = None,
    device=None,
):
    """``alpha * op(a) @ op(b) + beta * c`` with the selected compute mode.

    Returns the same container kind as ``a`` (numpy -> numpy, tensor ->
    tensor).  ``device`` places numpy inputs (default: the handle's
    device); tensors run where they lie.  If no such device exists, torch
    raises — nothing silently moves to the CPU.  Complex operands run the
    4-pass complex engine.

    ``op_a``/``op_b`` accept ``"N"``, ``"T"`` and ``"C"`` (exact conjugate
    transpose); on real operands C and T coincide.

    Modes: ``fp64_int8_3`` .. ``fp64_int8_18``; ``fp64_int8_auto`` (also
    what an unset mode resolves to) picks one of those from the operands'
    mantissa loss, or falls back to ``dgemm``; ``dgemm`` is torch's f64
    (complex128) matmul; ``sgemm`` demotes the operands to f32.

    NaN/Inf contract (same as the reference, whose split kernel reads
    exponent bits without a non-finite check, split.cu:154-185): a NaN or
    +-Inf element makes its OWN output row (via A) or column (via B)
    garbage.  Set ``OZIMMU_CHECK_FINITE=1`` to raise ``ValueError`` on
    non-finite numpy inputs instead.
    """
    handle = handle or default_handle()
    if isinstance(a, np.ndarray) and env_flag("OZIMMU_CHECK_FINITE", False):
        for nm, arr in (("a", a), ("b", b), ("c", c)):
            if arr is not None and not np.isfinite(arr).all():
                raise ValueError(
                    f"non-finite values in operand {nm} "
                    "(OZIMMU_CHECK_FINITE=1; NaN/Inf are outside the "
                    "engine contract)"
                )
    mode_r = handle.resolve_mode(mode)
    op_a = Operation.parse(op_a)
    op_b = Operation.parse(op_b)
    is_np, at, bt, ct = _operands(a, b, c, handle, device)
    if any(x is not None and x.is_complex() for x in (at, bt, ct)):
        return _gemm_complex(handle, at, bt, ct, mode_r, op_a, op_b, alpha, beta, is_np)
    dev = at.device
    at, bt = _apply_op(at, op_a), _apply_op(bt, op_b)

    m, k = at.shape
    k2, n = bt.shape
    if k != k2:
        raise ValueError(f"shape mismatch: op(a)={tuple(at.shape)} @ op(b)={tuple(bt.shape)}")
    if ct is not None and tuple(ct.shape) != (m, n):
        raise ValueError(f"c has shape {tuple(ct.shape)}, expected {(m, n)}")
    if beta != 0.0 and ct is None:
        raise ValueError("beta != 0 requires c")
    if k == 0:  # BLAS: C <- beta * C, in every mode
        out = _k0_result(float(beta), ct, (m, n), dev)
        return out.cpu().numpy() if is_np else out

    if mode_r is ComputeMode.FP64_INT8_AUTO:
        mode_r = _auto_mode_select_core(at, bt, k, handle.avg_mantissa_loss_threshold)
        log(
            f"AUTO selected mode = {mode_r.value}, threshold average mantissa "
            f"loss = {handle.avg_mantissa_loss_threshold}"
        )

    name = f"ozimmu_gemm-{mode_r.value}-m{m}-n{n}-k{k}"
    with culip_timer(name, sync_fn=lambda: synchronize(dev)):
        if mode_r.is_int8:
            _check_k_supported(k)
            at, bt = at.contiguous(), bt.contiguous()
            if handle.profiler.enabled:
                out = _gemm_staged(handle, at, bt, mode_r.num_split, alpha, beta, ct)
            else:
                out = gemm_f64(at, bt, mode_r.num_split, alpha=alpha, beta=beta, c=ct)
        elif mode_r is ComputeMode.SGEMM:
            out = _sgemm_core(at, bt)
            if alpha != 1.0 or beta != 0.0:
                # fold alpha/beta exactly on the widened result (the JAX
                # package's _epilogue_scalar, which is this epilogue)
                t, E = unpack_f64(out)
                out = _epilogue_SE(t, E, float(alpha), float(beta), ct)
        elif mode_r is ComputeMode.DGEMM:
            out = torch.matmul(at, bt)
            out = alpha * out + (beta * ct if beta != 0.0 else 0.0)
        else:
            raise NotImplementedError(f"mode {mode_r} not implemented")

    return out.cpu().numpy() if is_np else out


def _gemm_complex(handle: Handle, at, bt, ct, mode_r: ComputeMode, op_a, op_b, alpha, beta,
                  is_np: bool):
    """Complex GEMM (the JAX package's ``_gemm_complex_np``) on complex128
    tensors; real operands are promoted."""
    at = _apply_op(at.to(torch.complex128), op_a)
    bt = _apply_op(bt.to(torch.complex128), op_b)
    ct = ct.to(torch.complex128) if ct is not None else None
    m, k = at.shape
    k2, n = bt.shape
    if k != k2:
        raise ValueError(f"shape mismatch: op(a)={tuple(at.shape)} @ op(b)={tuple(bt.shape)}")
    if ct is not None and tuple(ct.shape) != (m, n):
        raise ValueError(f"c has shape {tuple(ct.shape)}, expected {(m, n)}")
    if beta != 0 and ct is None:
        raise ValueError("beta != 0 requires c")
    dev = at.device
    alpha, beta = complex(alpha), complex(beta)
    if k == 0:  # BLAS: C <- beta * C, in every mode
        c_planes = _planes(ct) if ct is not None else (None, None)
        return _complex_result(*_zk0_result(beta, *c_planes, (m, n), dev), is_np)

    # the dgemm mode alone runs on the complex tensors themselves
    ab_planes = (*_planes(at), *_planes(bt)) if mode_r is not ComputeMode.DGEMM else None
    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # ONE shared loss counter over all four re/im planes (reference
        # complex estimator split.cu:69-152 + selection 473-493)
        mode_r = auto_mode_select_complex(*ab_planes, k, handle.avg_mantissa_loss_threshold)
        log(f"AUTO selected mode = {mode_r.value} (complex)")

    name = f"ozimmu_zgemm-{mode_r.value}-m{m}-n{n}-k{k}"
    with culip_timer(name, sync_fn=lambda: synchronize(dev)):
        c_planes = _planes(ct) if ct is not None else (None, None)
        if mode_r.is_int8:
            _check_k_supported(k)
            args = (*ab_planes, mode_r.num_split, alpha, beta, *c_planes)
            if handle.profiler.enabled:
                re, im = _zgemm_staged(handle, *args)
            else:
                re, im = zgemm_f64(*args)
        elif mode_r is ComputeMode.DGEMM:
            out = alpha * torch.matmul(at, bt)
            if beta != 0:
                out = out + beta * ct
            return out.cpu().numpy() if is_np else out
        elif mode_r is ComputeMode.SGEMM:
            re, im = _csgemm_core(*ab_planes, alpha, beta, *c_planes)
        else:
            raise NotImplementedError(f"mode {mode_r} not implemented (complex)")
    return _complex_result(re, im, is_np)


def matmul(a: ArrayLike, b: ArrayLike, *, mode: Optional[ComputeModeLike] = None,
           handle=None, device=None):
    """NumPy-style ``a @ b`` through the engine."""
    return gemm(a, b, mode=mode, handle=handle, device=device)


def gemm_batched(
    a: ArrayLike,
    b: ArrayLike,
    *,
    mode: Optional[ComputeModeLike] = None,
    alpha=1.0,
    beta=0.0,
    c: Optional[ArrayLike] = None,
    handle: Optional[Handle] = None,
    device=None,
):
    """Batched GEMM ``alpha * a[i] @ b[i] + beta * c[i]`` for a [B, m, k],
    b [B, k, n] and c [B, m, n] (strided-batched parity, reference
    cublas.cu:380-406).  The int8 modes run the batched engine
    (``core.gemm.gemm_f64_batched``): each kernel launches once per
    sub-batch, as the JAX package's ``vmap`` makes one call of each.  Real
    and complex batches; one AUTO mode for the whole batch.  Numpy or
    tensor inputs, placed and returned as :func:`gemm` does."""
    handle = handle or default_handle()
    mode_r = handle.resolve_mode(mode)
    is_np, at, bt, ct = _operands(a, b, c, handle, device)
    if at.dim() != 3 or bt.dim() != 3 or at.shape[0] != bt.shape[0] or at.shape[2] != bt.shape[1]:
        raise ValueError(f"batched shape mismatch: {tuple(at.shape)} @ {tuple(bt.shape)}")
    B, m, k = at.shape
    n = bt.shape[2]
    if ct is not None and tuple(ct.shape) != (B, m, n):
        raise ValueError(f"c has shape {tuple(ct.shape)}, expected {(B, m, n)}")
    if beta != 0 and ct is None:
        raise ValueError("beta != 0 requires c")
    if any(x is not None and x.is_complex() for x in (at, bt, ct)):
        return _gemm_batched_complex(handle, at, bt, ct, mode_r, alpha, beta, is_np)
    if k == 0:  # BLAS: C <- beta * C, in every mode
        out = _k0_result(float(beta), ct, (B, m, n), at.device)
        return out.cpu().numpy() if is_np else out

    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # one mode for the whole batch, selected on the flattened batch
        mode_r = _auto_mode_select_core(
            at.reshape(-1, k), bt.transpose(1, 2).reshape(-1, k), k,
            handle.avg_mantissa_loss_threshold, b_is_cols=False)
        log(f"AUTO selected mode = {mode_r.value} (batched)")
    if mode_r is ComputeMode.SGEMM:
        # f32-demoted batch (reference dgemm_f32_batched,
        # cublas_helper.cu:20-67); alpha/beta in plain f64 as the JAX
        # package's batched path does
        out = _sgemm_core(at, bt) * alpha
    elif not mode_r.is_int8:
        out = torch.matmul(at, bt) * alpha
    else:
        _check_k_supported(k)
        out = gemm_f64_batched(at, bt, mode_r.num_split, float(alpha), float(beta), ct)
        return out.cpu().numpy() if is_np else out
    if beta != 0:
        out = out + beta * ct
    return out.cpu().numpy() if is_np else out


def _gemm_batched_complex(handle: Handle, at, bt, ct, mode_r: ComputeMode, alpha, beta,
                          is_np: bool):
    """Complex batch (reference ZgemmStridedBatched shim parity)."""
    at, bt = at.to(torch.complex128), bt.to(torch.complex128)
    ct = ct.to(torch.complex128) if ct is not None else None
    k = at.shape[2]
    a_re, a_im = _planes(at)
    b_re, b_im = _planes(bt)
    c_re, c_im = _planes(ct) if ct is not None else (None, None)
    al, be = complex(alpha), complex(beta)
    if k == 0:  # BLAS: C <- beta * C, in every mode
        shape = (at.shape[0], at.shape[1], bt.shape[2])
        return _complex_result(*_zk0_result(be, c_re, c_im, shape, at.device), is_np)
    if mode_r is ComputeMode.FP64_INT8_AUTO:
        # one mode for the whole batch: the shared four-plane counter over
        # the flattened batch (rows of [B*m, k] / [B*n, k] are exactly the
        # per-matrix scale groups)
        mode_r = auto_mode_select_complex(
            a_re.reshape(-1, k), a_im.reshape(-1, k),
            b_re.transpose(1, 2).reshape(-1, k), b_im.transpose(1, 2).reshape(-1, k),
            k, handle.avg_mantissa_loss_threshold, b_is_cols=False)
        log(f"AUTO selected mode = {mode_r.value} (batched complex)")
    if mode_r is ComputeMode.SGEMM:
        # f32-demoted complex batch (reference CgemmStridedBatched
        # demotion, cublas_helper.cu:190-216)
        re, im = _csgemm_core(a_re, a_im, b_re, b_im, al, be, c_re, c_im)
        return _complex_result(re, im, is_np)
    if not mode_r.is_int8:
        out = torch.matmul(at, bt) * al
        if be != 0:
            out = out + be * ct
        return out.cpu().numpy() if is_np else out
    _check_k_supported(k)
    re, im = zgemm_f64_batched(a_re, a_im, b_re, b_im, mode_r.num_split, al, be, c_re, c_im)
    return _complex_result(re, im, is_np)


def auto_mode_select(
    a: ArrayLike,
    b: ArrayLike,
    *,
    op_a: OperationLike = Operation.N,
    op_b: OperationLike = Operation.N,
    threshold: Optional[float] = None,
    handle: Optional[Handle] = None,
    device=None,
) -> ComputeMode:
    """Standalone AUTO query (reference ozimmu.hpp:84-92) on real operands:
    numpy float64 arrays (placed on ``device``, default the handle's) or
    float64 tensors."""
    handle = handle or default_handle()
    if threshold is None:
        threshold = handle.avg_mantissa_loss_threshold
    _, at, bt, _ = _operands(a, b, None, handle, device)
    if at.is_complex() or bt.is_complex():
        raise TypeError("auto_mode_select takes real operands")
    at = _apply_op(at, Operation.parse(op_a))
    bt = _apply_op(bt, Operation.parse(op_b))
    return _auto_mode_select_core(at, bt, at.shape[1], threshold)


def warmup(
    m: int,
    n: int,
    k: int,
    mode: ComputeModeLike,
    kind: ElementKind = ElementKind.REAL,
    handle: Optional[Handle] = None,
) -> None:
    """Make one GEMM shape cheap to run: build the CUDA kernels (on a CUDA
    handle) and run the GEMM once on zeros on the handle's device."""
    handle = handle or default_handle()
    mode = ComputeMode.parse(mode)
    dev = torch.device(handle.device)
    if dev.type == "cuda":
        from .. import native

        native.lib()
    dt = torch.complex128 if ElementKind(kind) is ElementKind.COMPLEX else torch.float64
    a = torch.zeros((m, k), dtype=dt, device=dev)
    b = torch.zeros((k, n), dtype=dt, device=dev)
    gemm(a, b, mode=mode, handle=handle)
    synchronize(dev)
