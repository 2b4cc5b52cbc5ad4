"""Public GEMM API: mode dispatch, operand normalization, profiling.

Port of the real-operand part of ``ozimmu_tpu.core.api``, the equivalent
of ``mtk::ozimmu::gemm`` (reference src/gemm.cu:524-653).

Input/output convention: row-major logical matrices, as numpy float64
arrays or torch float64 tensors (``a``, ``b`` and ``c`` of one kind).
Numpy inputs are placed on ``device`` (default: the handle's, ``"cuda"``)
and the result comes back as numpy; tensor inputs run on their own device
and the result is a tensor there.  ``op_a``/``op_b`` apply BLAS-style
transposes to the *logical* matrices: ``gemm(a, b, op_a="T")`` computes
``alpha * a.T @ b + beta * c``.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..ops.recombine import acc_shift, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import bits_per_int8
from ..types import ComputeMode, ComputeModeLike, Operation, OperationLike
from ..utils.env import env_flag
from ..utils.profiling import culip_timer, synchronize
from .gemm import _epilogue_SE, _exponent_plane, gemm_f64
from .handle import Handle, default_handle

ArrayLike = Union[np.ndarray, torch.Tensor]


def _not_ported(what: str, step: int):
    return NotImplementedError(
        f"{what} is not ported to ozimmu_tpu_torch yet (ROADMAP.md queue 1, step {step}); "
        "use ozimmu_tpu for it"
    )


def _apply_op(x: torch.Tensor, op: Operation) -> torch.Tensor:
    # real operands: C == T (conjugation is the identity)
    return x if op is Operation.N else x.T


def _to_tensor(x, name: str, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            raise _not_ported("complex GEMM (ZGEMM)", 9)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(device)
    raise TypeError(f"operand {name}: expected a numpy array like a, got {type(x)}")


def _check_tensor(x, name: str) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"operand {name}: expected a torch tensor like a, got {type(x)}")
    if x.is_complex():
        raise _not_ported("complex GEMM (ZGEMM)", 9)
    if x.dtype != torch.float64:
        raise TypeError(f"operand {name}: expected float64, got {x.dtype}")
    return x


def _check_k_supported(k: int) -> None:
    if bits_per_int8(k) <= 0:
        raise ValueError(
            f"k={k} exceeds the int8 emulation bound (needs k*2^(2b) <= 2^31);"
            " shard or chunk the contraction"
        )


def _gemm_staged(handle: Handle, a, b, num_split: int, alpha: float, beta: float, c):
    """Phase-profiled engine: the same steps as core.gemm._gemm_core, each
    phase ended by a device synchronisation (reference labels
    gemm.cu:38-48,312,393,404)."""
    prof = handle.profiler
    dev = a.device
    k = a.shape[1]
    bb = bits_per_int8(k)
    with prof.phase("split_A", sync=dev):
        da, pa = split_f64(a, num_split, bb)
    with prof.phase("split_B", sync=dev):
        db, pb = split_f64_cols(b, num_split, bb)
    with prof.phase("int8tc+accumulate_in_f64", sync=dev):
        S = recombine(da, db, num_split, bb, k)
    with prof.phase("copy_result", sync=dev):
        E = _exponent_plane(pa, pb, acc_shift(num_split, bb))
        out = _epilogue_SE(S, E, float(alpha), float(beta), c)
    return out


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
    raises — nothing silently moves to the CPU.

    ``op_a``/``op_b`` accept ``"N"``, ``"T"`` and ``"C"``; on real
    operands C and T coincide.

    NaN/Inf contract (same as the reference, whose split kernel reads
    exponent bits without a non-finite check, split.cu:154-185): a NaN or
    +-Inf element makes its OWN output row (via A) or column (via B)
    garbage.  Set ``OZIMMU_CHECK_FINITE=1`` to raise ``ValueError`` on
    non-finite numpy inputs instead.

    Implemented modes: ``fp64_int8_3`` .. ``fp64_int8_18`` and ``dgemm``.
    ``fp64_int8_auto`` (also what an unset mode resolves to), ``sgemm``
    and complex operands raise ``NotImplementedError``.
    """
    handle = handle or default_handle()
    is_np = isinstance(a, np.ndarray)
    if is_np and env_flag("OZIMMU_CHECK_FINITE", False):
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

    if is_np:
        dev = torch.device(device if device is not None else handle.device)
        at, bt = _to_tensor(a, "a", dev), _to_tensor(b, "b", dev)
        ct = _to_tensor(c, "c", dev) if c is not None else None
    else:
        at, bt = _check_tensor(a, "a"), _check_tensor(b, "b")
        ct = _check_tensor(c, "c") if c is not None else None
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

    if mode_r is ComputeMode.FP64_INT8_AUTO:
        raise _not_ported("fp64_int8_auto (AUTO mode selection)", 8)
    if mode_r is ComputeMode.SGEMM:
        raise _not_ported("the sgemm mode", 10)

    name = f"ozimmu_gemm-{mode_r.value}-m{m}-n{n}-k{k}"
    with culip_timer(name, sync_fn=lambda: synchronize(dev)):
        if mode_r.is_int8:
            _check_k_supported(k)
            at, bt = at.contiguous(), bt.contiguous()
            if handle.profiler.enabled:
                out = _gemm_staged(handle, at, bt, mode_r.num_split, alpha, beta, ct)
            else:
                out = gemm_f64(at, bt, mode_r.num_split, alpha=alpha, beta=beta, c=ct)
        elif mode_r is ComputeMode.DGEMM:
            out = torch.matmul(at, bt)
            out = alpha * out + (beta * ct if beta != 0.0 else 0.0)
        else:
            raise NotImplementedError(f"mode {mode_r} not implemented")

    return out.cpu().numpy() if is_np else out


def matmul(a: ArrayLike, b: ArrayLike, *, mode: Optional[ComputeModeLike] = None,
           handle=None, device=None):
    """NumPy-style ``a @ b`` through the engine."""
    return gemm(a, b, mode=mode, handle=handle, device=device)


def gemm_batched(*args, **kwargs):
    """Batched GEMM: not ported yet."""
    raise _not_ported("gemm_batched", 11)
