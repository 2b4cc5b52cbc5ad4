"""Engine calls inside compiled PyTorch code (``torch.compile``).

Port of ``ozimmu_tpu.traced``.  The public :func:`ozimmu_tpu_torch.gemm`
takes numpy or tensors and resolves modes on the host, and the interceptor
is global state that ``torch.compile(fullgraph=True)`` refuses to trace
under.  This module is the third surface: call the engine inside your own
compiled code::

    from ozimmu_tpu_torch import traced

    @torch.compile(fullgraph=True)
    def step(a, b, c):                  # float64 / complex128 tensors
        return traced.gemm(a, b, alpha=2.0, beta=1.0, c=c, num_split=9)

Each function is a ``torch.library.custom_op`` (``ozimmu_tpu_torch::gemm``,
``ozimmu_tpu_torch::gemm_batched``) with a fake implementation for shapes,
so a compiled graph holds it as one opaque node.  Its body runs eagerly —
the split and recombine kernels on CUDA tensors, their plain versions on
the CPU — and is never compiled itself (the triple-f32 arithmetic must not
be contracted into FMAs).  Complex ``alpha`` and ``beta`` cross the op's
schema as separate real and imaginary floats.

Semantics match ``mtk::ozimmu::gemm`` (reference src/gemm.cu:524-653):
``alpha * a @ b + beta * c`` at a fixed split count.  As in the JAX
module there is no AUTO mode and no autograd here: for data-driven split
counts use the interceptor (ozimmu_tpu_torch.intercept) outside compiled
code.
"""

from __future__ import annotations

from typing import Optional

import torch

from .core.gemm import gemm_int8


def _engine(a, b, c, num_split: int, alpha: complex, beta: complex, n_chunks=None):
    """The engine on one [m, k] @ [k, n] product or on a batch
    [B, m, k] @ [B, k, n], real or complex."""
    a, b = a.resolve_conj().resolve_neg(), b.resolve_conj().resolve_neg()
    if c is not None:
        c = c.resolve_conj().resolve_neg()
    if not a.is_complex():
        alpha, beta = alpha.real, beta.real
    return gemm_int8(a, b, num_split, alpha, beta, c, n_chunks)


@torch.library.custom_op("ozimmu_tpu_torch::gemm", mutates_args=())
def _gemm_op(
    a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor], num_split: int,
    alpha_re: float, alpha_im: float, beta_re: float, beta_im: float, n_chunks: Optional[int],
) -> torch.Tensor:
    return _engine(a, b, c, num_split, complex(alpha_re, alpha_im),
                   complex(beta_re, beta_im), n_chunks=n_chunks)


@_gemm_op.register_fake
def _(a, b, c, num_split, alpha_re, alpha_im, beta_re, beta_im, n_chunks):
    return a.new_empty((a.shape[0], b.shape[1]))


@torch.library.custom_op("ozimmu_tpu_torch::gemm_batched", mutates_args=())
def _gemm_batched_op(
    a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor], num_split: int,
    alpha_re: float, alpha_im: float, beta_re: float, beta_im: float,
) -> torch.Tensor:
    return _engine(a, b, c, num_split, complex(alpha_re, alpha_im), complex(beta_re, beta_im))


@_gemm_batched_op.register_fake
def _(a, b, c, num_split, alpha_re, alpha_im, beta_re, beta_im):
    return a.new_empty((a.shape[0], a.shape[1], b.shape[2]))


def _promote(a, b, c, alpha, beta):
    """Operands in one dtype (complex128 if any is complex, else float64)
    and the scalars as (re, im, re, im) floats; a complex scalar on real
    operands raises, as ``float()`` does in the JAX module."""
    if a.is_complex() or b.is_complex():
        dt = torch.complex128
        al, be = complex(alpha), complex(beta)
    else:
        dt = torch.float64
        al, be = complex(float(alpha)), complex(float(beta))
    a, b = a.to(dt), b.to(dt)
    c = c.to(dt) if c is not None else None
    return a, b, c, (al.real, al.imag, be.real, be.imag)


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    num_split: int = 9,
    alpha=1.0,
    beta=0.0,
    c: Optional[torch.Tensor] = None,
    n_chunks: Optional[int] = None,
) -> torch.Tensor:
    """``alpha * a @ b + beta * c`` on [m, k] @ [k, n] tensors, traceable by
    ``torch.compile(fullgraph=True)``.

    float64 inputs run the real engine; complex128 inputs (or any complex
    operand) the 4-pass complex engine.  ``n_chunks=None`` auto-selects
    column-panel streaming from the working-set estimate; pass 1 to force
    the single-pass engine.  Chunked results are bitwise identical.
    """
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    a, b, c, scalars = _promote(a, b, c, alpha, beta)
    return _gemm_op(a, b, c, num_split, *scalars, n_chunks)


def matmul(a: torch.Tensor, b: torch.Tensor, *, num_split: int = 9) -> torch.Tensor:
    """``a @ b`` through the engine, traceable by ``torch.compile``."""
    return gemm(a, b, num_split=num_split)


def gemm_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    num_split: int = 9,
    alpha=1.0,
    beta=0.0,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched GEMM [B, m, k] @ [B, k, n] (+ beta * c [B, m, n]), each
    matrix with its own scales (the JAX module's ``vmap``), traceable by
    ``torch.compile(fullgraph=True)``."""
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"expected 3D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    a, b, c, scalars = _promote(a, b, c, alpha, beta)
    return _gemm_batched_op(a, b, c, num_split, *scalars)
