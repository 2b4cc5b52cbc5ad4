"""Drop-in interception of float64 / complex128 matmuls in PyTorch programs.

Port of ``ozimmu_tpu.intercept``, the torch form of the reference's
LD_PRELOAD cuBLAS shim (src/cublas.cu:103-513).  Instead of patching JAX's
defining ``dot_general``, a ``TorchDispatchMode`` sees the four aten
overloads every matmul form reaches, and reroutes the qualifying ones
through the engine:

  * ``aten.mm``: ``@`` and ``torch.matmul`` on 2-D operands,
    ``tensordot``, ``F.linear`` without bias, the backward of ``mm``, and
    ``[B, m, k] @ [k, n]`` (which torch folds into one ``[B*m, k] @ [k, n]``);
  * ``aten.bmm``: batched ``@`` (any number of batch dimensions, folded)
    and ``einsum`` (a 2-D ``einsum`` arrives as ``bmm`` with batch 1, which
    is routed as the 2-D product it is);
  * ``aten.addmm`` / ``aten.baddbmm``: ``F.linear`` with a bias,
    ``torch.addmm`` and ``torch.baddbmm``.  The product goes through the
    engine and ``beta * input + alpha * product`` is then applied with
    native torch ops — the JAX semantics of ``x @ w + b``, where only the
    contraction is rerouted — not the engine's exact c/beta epilogue.

The mode sits below autograd, so backward products are rerouted too, and
the autograd graph is untouched.  It takes itself off the mode stack while
its handler runs, so the engine's own torch calls are never re-intercepted
(the JAX package's ``in_engine`` flag).

Gate (reference cublas.cu:142-148): the compute mode is not ``dgemm``,
both operands are float64 or both complex128, and m, n and k each reach
their own ``intercept_threshold_{m,n,k}`` (from the handle, or the default
handle: env ``OZIMMU_INTERCEPT_THRESHOLD_{M,N,K}``, default 1024).  The
mode is the one pinned by ``enable(mode=...)``, else ``OZIMMU_COMPUTE_MODE``
read on every call (cublas.cu:18-48; an unparsable value means ``dgemm``);
with neither, nothing is intercepted.

Deviations from the JAX package (ROADMAP.md, queue 3):

  (a) ``[B, m, k] @ [k, n]`` is routed as one folded ``mm``; the JAX
      interceptor leaves that contraction native.
  (b) Batched AUTO chooses among all 16 split counts (with
      ``auto_fallback_mode``), as the port's ``gemm_batched`` does; the
      JAX interceptor chooses among a pruned candidate set plus native.
  (c) An engine error on a non-CPU tensor propagates: a kernel that fails
      to build or launch is never hidden behind a native result.  On CPU
      tensors the JAX behaviour stays: the error is logged and the call
      runs native.
  (d) ``mode="sgemm"`` is the reference shim's f32 demotion
      (cublas_helper.cu:20-216); the JAX interceptor logs an error and
      runs native f64 for it.

Not ported: the traced f64 <-> F64X peel (torch has IEEE f64) and the
traced-AUTO ``lax.switch`` with its candidate pruning (AUTO here is eager
and data-driven on every call).  ``torch.compile(fullgraph=True)`` refuses
to trace while a dispatch mode is active; without ``fullgraph`` the frame
runs eagerly under the mode and is intercepted.  Inside compiled code, call
:mod:`ozimmu_tpu_torch.traced` instead.

Usage::

    import ozimmu_tpu_torch.intercept as ozi
    ozi.enable(mode="fp64_int8_9")      # this thread, until disable()
    ...
    ozi.disable()

    with ozi.intercept(mode="fp64_int8_auto"):
        c = a @ b                       # rerouted when it qualifies
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..core import api
from ..core.handle import Handle, default_handle
from ..ops.mantissa_loss import auto_mode_select, auto_mode_select_complex
from ..types import ComputeMode
from ..utils.env import env_compute_mode, env_flag
from ..utils.log import error, log
from ..utils.profiling import culip_timer, span, synchronize

_state = threading.local()


def _tls():
    """This thread's interception state: the dispatch mode it pushed, or
    None.  The pinned mode and the handle live on that mode object, which
    autograd's worker threads inherit with the mode stack."""
    if not hasattr(_state, "dispatch"):
        _state.dispatch = None
    return _state


# ---------------------------------------------------------------------------
# gating and routing
# ---------------------------------------------------------------------------


def _current_mode(pinned: Optional[ComputeMode]) -> ComputeMode:
    if pinned is not None:
        return pinned
    env = env_compute_mode()  # read per call, reference cublas.cu:18-48
    if env is not None:
        try:
            return ComputeMode.parse(env)
        except ValueError:
            return ComputeMode.DGEMM
    return ComputeMode.DGEMM  # no mode configured -> no interception


def _qualifies(m: int, n: int, k: int, a: torch.Tensor, b: torch.Tensor, mode: ComputeMode,
               handle: Handle) -> bool:
    if mode is ComputeMode.DGEMM:
        return False
    if a.dtype != b.dtype or a.dtype not in (torch.float64, torch.complex128):
        return False
    return (
        m >= handle.intercept_threshold_m
        and n >= handle.intercept_threshold_n
        and k >= handle.intercept_threshold_k
    )


def _plain(x: torch.Tensor) -> torch.Tensor:
    """``x`` materialised: conj and neg bits resolved (``x.mH`` arrives with
    a conj bit), contiguous."""
    return x.resolve_conj().resolve_neg().contiguous()


def _route_2d(mode: ComputeMode, handle: Handle, a: torch.Tensor, b: torch.Tensor):
    """[m, k] @ [k, n] through ``core.api.gemm``, or None to run native."""
    m, k = a.shape
    n = b.shape[1]
    if not _qualifies(m, n, k, a, b, mode, handle):
        return None
    a, b = _plain(a), _plain(b)
    if mode is ComputeMode.FP64_INT8_AUTO:
        thr = handle.avg_mantissa_loss_threshold
        if a.is_complex():
            mode = api._auto(auto_mode_select_complex, a.real.contiguous(), a.imag.contiguous(),
                             b.real.contiguous(), b.imag.contiguous(), k, thr)
        else:
            mode = api._auto(auto_mode_select, a, b, k, thr)
        log(f"AUTO selected mode = {mode.value} (intercept)")
        if not mode.is_int8:
            return None  # fall through to native
    with culip_timer(f"intercept_dot_general-m{m}-n{n}-k{k}", sync_fn=lambda: synchronize(a)):
        return api.gemm(a, b, mode=mode, handle=handle)


def _route_batched(mode: ComputeMode, handle: Handle, a: torch.Tensor, b: torch.Tensor):
    """[B, m, k] @ [B, k, n] through ``core.api.gemm_batched`` (one mode for
    the whole batch), or None to run native.  Batch 1 is the 2-D product."""
    bsz, m, k = a.shape
    n = b.shape[2]
    if not _qualifies(m, n, k, a, b, mode, handle):
        return None
    if bsz == 1:
        out = _route_2d(mode, handle, a[0], b[0])
        return None if out is None else out.unsqueeze(0)
    a, b = _plain(a), _plain(b)
    with culip_timer(f"intercept_dot_general_batched-b{bsz}-m{m}-n{n}-k{k}",
                     sync_fn=lambda: synchronize(a)):
        return api.gemm_batched(a, b, mode=mode, handle=handle)


def _add_input(inp: torch.Tensor, prod: torch.Tensor, beta, alpha) -> torch.Tensor:
    """``beta * inp + alpha * prod`` with native torch ops (``inp`` is
    ignored when ``beta`` is 0, as aten's addmm does)."""
    if alpha != 1:
        prod = prod * alpha
    if beta == 0:
        return prod
    return prod + (inp if beta == 1 else inp * beta)


def _addmm(mode, handle, inp, a, b, *, beta=1, alpha=1):
    prod = _route_2d(mode, handle, a, b)
    return None if prod is None else _add_input(inp, prod, beta, alpha)


def _baddbmm(mode, handle, inp, a, b, *, beta=1, alpha=1):
    prod = _route_batched(mode, handle, a, b)
    return None if prod is None else _add_input(inp, prod, beta, alpha)


_ROUTES = {"mm": _route_2d, "bmm": _route_batched, "addmm": _addmm, "baddbmm": _baddbmm}


def _reroute(route, args, kwargs, pinned: Optional[ComputeMode], handle: Optional[Handle]):
    """The routed result, or None to run the op native."""
    mode = _current_mode(pinned)
    if mode is ComputeMode.DGEMM:
        return None
    try:
        return route(mode, handle or default_handle(), *args, **kwargs)
    except Exception as e:
        # deviation (c): never hide a device failure behind a native result
        if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in args):
            raise
        # CPU tensors keep the JAX package's policy: native, but LOUDLY
        # (reference utils.hpp:133-137 logs its fallbacks the same way)
        error(f"interception fell back to native: {type(e).__name__}: {e}")
        return None


# ---------------------------------------------------------------------------
# the dispatch mode
# ---------------------------------------------------------------------------


class PatchPointError(RuntimeError):
    """The torch internals this interceptor hooks moved or vanished.

    Raised LOUDLY instead of silently serving native matmuls — the
    interception contract is "qualifying f64 contractions go through the
    engine" (the failure mode the reference's LD_PRELOAD design cannot
    have: a missing symbol fails at link time)."""


def _discover_patch_points():
    """``(TorchDispatchMode, {name: aten overload})``, failing loudly with
    version info."""
    try:
        from torch.utils._python_dispatch import TorchDispatchMode
    except ImportError as e:
        raise PatchPointError(
            f"ozimmu interception does not support torch {torch.__version__}: "
            f"torch.utils._python_dispatch.TorchDispatchMode is gone ({e}); the "
            "interceptor needs porting to this torch release"
        ) from e
    ops = {}
    for name in _ROUTES:
        try:
            ops[name] = getattr(torch.ops.aten, name).default
        except (AttributeError, RuntimeError) as e:
            raise PatchPointError(
                f"ozimmu interception does not support torch {torch.__version__}: "
                f"aten.{name}.default not found ({e}); the interceptor needs "
                "porting to this torch release"
            ) from e
    return TorchDispatchMode, ops


def _new_dispatch_mode(pinned: Optional[ComputeMode], handle: Optional[Handle]):
    base, ops = _discover_patch_points()
    routes = {op: _ROUTES[name] for name, op in ops.items()}

    class _InterceptMode(base):
        def __init__(self):
            super().__init__()
            self.pinned = pinned
            self.handle = handle

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            route = routes.get(func)
            if route is not None:
                with span("oz.intercept"):
                    out = _reroute(route, args, kwargs, self.pinned, self.handle)
                if out is not None:
                    return out
            return func(*args, **kwargs)

    return _InterceptMode()


def _warmup_default(mode: ComputeMode, handle: Handle) -> None:
    """Run the default interception shape once (reference cublasCreate_v2
    pre-allocates a 1024^3 int8_9 arena, cublas.cu:12-16): the kernel build
    and a first run, so the first intercepted call does not pay them."""
    m = max(1024, handle.intercept_threshold_m)
    n = max(1024, handle.intercept_threshold_n)
    k = max(1024, handle.intercept_threshold_k)
    api.warmup(m, n, k, mode, handle=handle)
    log(f"interception warmed up for {m}x{n}x{k}")


def enable(
    mode=None,
    handle: Optional[Handle] = None,
    warmup: Optional[bool] = None,
    clear_caches: bool = True,
) -> None:
    """Intercept qualifying matmuls on this thread (and in the autograd
    work it starts) until :func:`disable`.

    ``mode`` pins the compute mode; None reads ``OZIMMU_COMPUTE_MODE`` on
    every call.  ``handle`` supplies the thresholds (default: the default
    handle).  Calling it again while enabled updates the mode and handle.

    ``warmup=True`` (or env ``OZIMMU_WARMUP_ON_ENABLE=1``) runs the
    default 1024^3 shape once, like the reference's ``cublasCreate_v2``
    arena pre-allocation (cublas.cu:12-16,104-115).

    ``clear_caches`` is kept for parity with the JAX package, where jit
    traces cached before ``enable`` baked in the native ``dot_general``
    and had to be dropped.  Nothing needs clearing in torch: eager calls
    reach the dispatch mode every time, and ``torch.compile`` runs a frame
    eagerly while the mode is active, even one compiled before.
    """
    del clear_caches
    tls = _tls()
    pinned = ComputeMode.parse(mode) if mode is not None else None
    if tls.dispatch is None:
        tls.dispatch = _new_dispatch_mode(pinned, handle)
        tls.dispatch.__enter__()
    tls.dispatch.pinned, tls.dispatch.handle = pinned, handle
    log("interception enabled")
    if warmup is None:
        warmup = env_flag("OZIMMU_WARMUP_ON_ENABLE", False)
    if warmup:
        h = handle or default_handle()
        _warmup_default(_current_mode(pinned), h)


def disable(clear_caches: bool = True) -> None:
    """Undo :func:`enable` on this thread (``clear_caches``: see there)."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    del clear_caches
    tls = _tls()
    if tls.dispatch is not None:
        if _get_current_dispatch_mode() is not tls.dispatch:
            raise RuntimeError(
                "interception cannot be disabled: a dispatch mode entered after "
                "enable() is still active; exit it first"
            )
        tls.dispatch.__exit__(None, None, None)
        tls.dispatch = None
    log("interception disabled")


@contextlib.contextmanager
def intercept(mode=None, handle: Optional[Handle] = None, clear_caches: bool = True):
    """:func:`enable` for the block; the previous state comes back after it."""
    tls = _tls()
    prev = None if tls.dispatch is None else (tls.dispatch.pinned, tls.dispatch.handle)
    enable(mode, handle, clear_caches=clear_caches)
    try:
        yield
    finally:
        if prev is None:
            disable()
        else:
            enable(*prev, warmup=False)
