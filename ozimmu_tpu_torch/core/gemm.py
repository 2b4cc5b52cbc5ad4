"""The GEMM engine: split -> recombination -> exact epilogue.

Port of ``ozimmu_tpu.core.gemm``, the equivalent of the reference
orchestration layer (src/gemm.cu:344-521 ``gemm_int8<double>`` and
``gemm_int8<cuDoubleComplex>``, the 4-pass complex engine):

  * equal-weight slice pairs are summed in int32 before any float work
    (ops/recombine.py);
  * the epilogue (alpha/beta folding, reference gemm.cu:124-239) runs in
    triple-f32 extended precision with a single final rounding.

Operands are float64 tensors; every step runs on the operands' device.
On a CUDA device the split, the recombination and the epilogue (or the
complex fold) are the hand-written kernels (ops/split_cuda.py,
ops/recombine_cuda.py, ops/epilogue_cuda.py), one launch of the epilogue
per output or column panel; on the CPU, their plain PyTorch versions.

BLAS defines a product with k = 0 as ``C <- beta * C``: the engine returns
that, or zeros where beta == 0 or c is None (c is then never read), and
launches nothing.

Layout contract: row-major logical matrices.  ``gemm_f64(a, b)`` computes
``alpha * (a @ b) + beta * c`` for a [m, k] and b [k, n]; ``zgemm_f64``
does the same on the real and imaginary float64 planes of complex
operands.  ``gemm_f64_batched`` and ``zgemm_f64_batched`` take batches
[B, m, k] @ [B, k, n], each matrix with its own scales (the JAX package's
``vmap`` of the cores), and launch each kernel once for as many matrices
as the memory budget holds.  Transpose flags are applied by the public
API (core/api.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import tf32x3
from ..ops.pack import aligned_add, pack_f64, scalar_triple, unpack_f64
from ..ops.recombine import acc_shift, padded_k, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import (
    auto_n_chunks, bits_per_int8, epilogue_block_bytes, hbm_budget_bytes,
    working_set_bytes_chunked,
)

#: live temporaries per output element of one block of the plain (CPU)
#: epilogue, an upper estimate that sets the block height: HPL's first
#: trailing update, with beta * c, peaked at 243.7 B per output element
#: unblocked on an H100, the 24 B of S, E and the output included
#: (tools/torch_ab.py, PERF.md); the complex fold keeps two accumulators
#: and folds four passes.  The CUDA kernels hold no temporaries: on the
#: card the epilogue takes what the working-set model counts (S, E and the
#: output, schedule.BYTES_PER_OUTPUT_ELEMENT) and nothing else.
_EPILOGUE_TEMP_BYTES = 256
_ZFOLD_TEMP_BYTES = 512


def _temp_bytes(complex_: bool, device) -> int:
    """Epilogue temporaries per output element on ``device``: none where
    the kernel runs (CUDA), the plain version's estimate elsewhere."""
    if torch.device(device).type == "cuda":
        return 0
    return _ZFOLD_TEMP_BYTES if complex_ else _EPILOGUE_TEMP_BYTES


def _row_blocks(m: int, n: int, temp_bytes: int, device):
    """Row ranges ``slice(r0, r1)`` covering an m x n output, each short
    enough that ``temp_bytes`` per element stay within
    :func:`~ozimmu_tpu_torch.schedule.epilogue_block_bytes` of ``device``."""
    rows = max(1, epilogue_block_bytes(device) // max(1, temp_bytes * n))
    return [slice(r0, min(r0 + rows, m)) for r0 in range(0, m, rows)]


def _on_cuda(device) -> bool:
    """True on a CUDA device (the kernels), False on the CPU (the plain
    versions); raises on any other device."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return kind == "cuda"


class Exponents(NamedTuple):
    """The exponent of every output element by its parts: ``pa[r] + pb[c]
    - shift`` in int32, the plane :meth:`plane` builds.  ``pa`` int32 [m]
    and ``pb`` [n] (each operand's split scales), or a batch's [B, m] and
    [B, n].  The CUDA kernels form each element's exponent from the parts
    and never build the plane; the plain versions take the plane."""

    pa: torch.Tensor
    pb: torch.Tensor
    shift: int

    def plane(self) -> torch.Tensor:
        return _exponent_plane(self.pa, self.pb, self.shift)


def _as_plane(E) -> torch.Tensor:
    """The exponent plane of ``E``, :class:`Exponents` or a plane already."""
    return E.plane() if isinstance(E, Exponents) else E


def _epilogue_SE(S, E, alpha: float, beta: float, c: Optional[torch.Tensor],
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * (S * 2^E) + beta * c`` in extended precision, rounded to
    f64 once (reference axby, gemm.cu:124-158), into ``out`` (float64
    [m, n], e.g. a column panel of a wider output) or a new tensor.  ``E``
    is :class:`Exponents` or an int32 plane of S's shape.

    On a CUDA device, one launch of the epilogue kernel
    (ops/epilogue_cuda.py), a batch [B, m, n] included.  On the CPU, the
    plain version :func:`_epilogue_block` on the exponent plane, over row
    blocks where its eager passes' temporaries would not fit what the
    memory budget leaves: every pass is elementwise, so the blocking leaves
    the bits alone.  A batch [B, m, n] runs as its [B*m, n] view, for the
    same reason."""
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    if _on_cuda(S[0].device):
        from ..ops.epilogue_cuda import epilogue

        return epilogue(S, E, alpha, beta, c, out)
    E = _as_plane(E)
    shape, n = E.shape, E.shape[-1]
    E2 = E
    if E.dim() != 2:
        rows2 = lambda x: x.reshape(-1, n)  # noqa: E731
        S, E2 = tuple(map(rows2, S)), rows2(E)
        c = None if c is None else rows2(c)
    blocks = _row_blocks(E2.shape[0], n, _EPILOGUE_TEMP_BYTES, E.device)
    if len(blocks) == 1 and out is None:
        return _epilogue_block(S, E2, alpha, beta, c).view(shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.float64, device=E.device)
    o = out if out.dim() == 2 else out.view(-1, n)
    for rows in blocks:
        o[rows] = _epilogue_block(tuple(s[rows] for s in S), E2[rows], alpha, beta,
                                  None if c is None else c[rows])
    return out


def _epilogue_block(S, E, alpha: float, beta: float, c: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_epilogue_SE` on one block of rows."""
    E = _as_plane(E)
    dev = E.device
    if alpha != 1.0:
        at, ae = scalar_triple(alpha, device=dev)
        S = tf32x3.mul(S, at)
        E = E + ae
    if beta != 0.0:
        ct, cE = unpack_f64(c)
        if beta != 1.0:
            bt, be = scalar_triple(beta, device=dev)
            ct = tf32x3.mul(ct, bt)
            cE = cE + be
        S, E = aligned_add(S, E, ct, cE)
    return pack_f64(S, E)


def _k0_result(beta: float, c: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    """A product with k = 0 (BLAS: ``C <- beta * C``): ``beta * c``, one
    IEEE float64 multiply per element; zeros where beta == 0 or c is None,
    c then never read."""
    if c is not None and tuple(c.shape) != tuple(shape):
        raise ValueError(f"c has shape {tuple(c.shape)}, expected {tuple(shape)}")
    if beta == 0.0 or c is None:
        return torch.zeros(shape, dtype=torch.float64, device=device)
    return beta * c


def _zk0_result(beta: complex, c_re, c_im, shape, device):
    """The complex :func:`_k0_result` on planes: ``re = br*cr - bi*ci``,
    ``im = br*ci + bi*cr``, each an IEEE float64 operation (no fused
    multiply-add, so the bits are the same on every device); zeros where
    beta == 0 or c is None."""
    for x in (c_re, c_im):
        if x is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"c has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if beta == 0 or (c_re is None and c_im is None):
        return (torch.zeros(shape, dtype=torch.float64, device=device),
                torch.zeros(shape, dtype=torch.float64, device=device))
    cr, ci = (x if x is not None else torch.zeros(shape, dtype=torch.float64, device=device)
              for x in (c_re, c_im))
    br, bi = beta.real, beta.imag
    return br * cr - bi * ci, br * ci + bi * cr


def _exponent_plane(pa: torch.Tensor, pb: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 ``pa[:, None] + pb[None, :] - shift``, matrix by matrix for a
    batch pa [B, m], pb [B, n] (int32 so that the ZERO_ROW_PEXP sentinel
    arithmetic matches the JAX package's)."""
    return (pa[..., :, None] + pb[..., None, :] - shift).to(torch.int32)


def _gemm_core(a, b, num_split: int, alpha: float, beta: float, c=None) -> torch.Tensor:
    """Real-valued engine core on one device: [m, k] @ [k, n], or a batch
    [B, m, k] @ [B, k, n] with one split per operand, one recombination
    and one epilogue for the whole batch.  Both operands are split straight
    into the k-major, k-padded planes that recombine reads (no copy of
    either)."""
    k = a.shape[-1]
    bb = bits_per_int8(k)
    kp = padded_k(k)
    da, pa = split_f64(a, num_split, bb, kp)
    db, pb = split_f64_cols(b, num_split, bb, kp)
    S = recombine(da, db, num_split, bb, k, b_kmajor=True)
    return _epilogue_SE(S, Exponents(pa, pb, acc_shift(num_split, bb)), alpha, beta, c)


def _gemm_core_nchunked(a, b, num_split: int, n_chunks: int, alpha: float = 1.0,
                        beta: float = 0.0, c=None) -> torch.Tensor:
    """Column-panel-chunked engine: split A once, stream B in n panels.

    Bitwise-identical to :func:`_gemm_core` (B's split is per-column
    independent, the recombination sees the full k, and the epilogue is
    elementwise), but peak memory for the B planes / int32 partials /
    triple-f32 accumulator drops by ~n_chunks.  Any ``n`` (the last panel
    is simply narrower).  Each B panel is split where it lies in ``b`` (the
    kernels read it through its row stride), straight into k-major planes,
    and its epilogue writes the panel's columns of the output in place.
    """
    k = a.shape[1]
    n = b.shape[1]
    if n == 0:
        return _gemm_core(a, b, num_split, alpha, beta, c)
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    kp = padded_k(k)
    shift = acc_shift(num_split, bb)
    da, pa = split_f64(a, num_split, bb, kp)
    out = torch.empty((a.shape[0], n), dtype=torch.float64, device=a.device)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        db, pb = split_f64_cols(b[:, j0:j1], num_split, bb, kp)
        S = recombine(da, db, num_split, bb, k, b_kmajor=True)
        cj = c[:, j0:j1] if c is not None else None
        _epilogue_SE(S, Exponents(pa, pb, shift), alpha, beta, cj, out[:, j0:j1])
    return out


def gemm_f64(
    a: torch.Tensor,
    b: torch.Tensor,
    num_split: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
    n_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Emulated FP64 GEMM on float64 tensors: alpha*(a@b) + beta*c.

    ``a`` [m, k], ``b`` [k, n] (and ``c`` [m, n]) must lie on one device.
    ``n_chunks=None`` auto-selects column-panel streaming from the
    working-set estimate against that device's memory
    (schedule.auto_n_chunks); 1 forces the unchunked engine.  Chunked and
    unchunked results are bitwise identical.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"gemm_f64 takes float64 tensors, got {a.dtype} and {b.dtype}")
    if a.shape[1] > 0 and bits_per_int8(a.shape[1]) <= 0:
        raise ValueError(f"k={a.shape[1]} too large for int8 emulation")
    if b.device != a.device or (c is not None and c.device != a.device):
        raise ValueError("a, b and c must lie on one device")
    m, k = a.shape
    n = b.shape[1]
    if k == 0:
        return _k0_result(float(beta), c, (m, n), a.device)
    a, b = a.contiguous(), b.contiguous()
    if n_chunks is None:
        n_chunks = auto_n_chunks(m, n, k, num_split, device=a.device)
    if n_chunks > 1:
        return _gemm_core_nchunked(a, b, num_split, n_chunks, float(alpha), float(beta), c)
    return _gemm_core(a, b, num_split, float(alpha), float(beta), c)


# ---------------------------------------------------------------------------
# Complex engine: 4-pass real algorithm (reference gemm.cu:412-521).
# ---------------------------------------------------------------------------

#: the reference's pass order (gemm.cu:479-518): (A-part, B-part) with
#: 0 = real plane, 1 = imag plane.  The output bits depend on the order of
#: the aligned adds, so it stays exactly as the JAX package has it.
ZGEMM_PASSES = ((1, 1), (0, 0), (1, 0), (0, 1))

#: exponent of an empty accumulator: far enough below any real term that
#: the aligned add drops the zero triple it labels.
_EMPTY_EXP = -(2**20)


def _zfold_passes(SEs, m: int, n: int, alpha: complex, beta: complex, c_re, c_im, device,
                  out=None):
    """Fold the four pass results into the complex output (shared by the
    fused `_zgemm_core` and the staged/profiled path in core.api).

    ``SEs`` lists (S, E) per entry of :data:`ZGEMM_PASSES`, S [m, n] and E
    :class:`Exponents` (or, on the CPU, a plane; a batch's S by its
    [B*m, n] rows, its Exponents [B, m] and [B, n]).  Fold factors
    (reference gemm.cu:479-518): re*re -> +alpha, im*im -> -alpha, cross
    terms -> i*alpha; C is pre-scaled by beta (init_c_complex,
    gemm.cu:199-239).  Returns the (re, im) float64 planes, new or written
    into ``out`` (a pair [m, n], e.g. column panels of wider planes).  On a
    CUDA device, one launch of the fold kernel (ops/epilogue_cuda.py); on
    the CPU, the plain version :func:`_zfold_block` over row blocks, as
    :func:`_epilogue_SE` runs its plain version.
    """
    if _on_cuda(device):
        from ..ops.epilogue_cuda import zfold

        return zfold(SEs, alpha, beta, c_re, c_im, out)
    SEs = [(S, _as_plane(E).reshape(m, n)) for S, E in SEs]
    blocks = _row_blocks(m, n, _ZFOLD_TEMP_BYTES, device)
    if len(blocks) == 1 and out is None:
        return _zfold_block(SEs, m, n, alpha, beta, c_re, c_im, device)
    if out is None:
        out = tuple(torch.empty((m, n), dtype=torch.float64, device=device) for _ in range(2))
    out_re, out_im = out
    for rows in blocks:
        block = [(tuple(s[rows] for s in S), E[rows]) for S, E in SEs]
        out_re[rows], out_im[rows] = _zfold_block(
            block, rows.stop - rows.start, n, alpha, beta,
            None if c_re is None else c_re[rows], None if c_im is None else c_im[rows], device)
    return out_re, out_im


def _zfold_block(SEs, m: int, n: int, alpha: complex, beta: complex, c_re, c_im, device):
    """:func:`_zfold_passes` on one block of rows."""
    SEs = [(S, _as_plane(E).reshape(m, n)) for S, E in SEs]

    def empty():
        return (tf32x3.zeros((m, n), device=device),
                torch.full((m, n), _EMPTY_EXP, dtype=torch.int32, device=device))

    def init_part(cp):
        if beta == 0 or cp is None:
            return empty()
        return unpack_f64(cp)

    def cmul_fold(acc, fold_re, fold_im, S, E):
        """acc(+)= (fold_re + i*fold_im) * S*2^E  on (re, im) parts."""
        (tre, Ere), (tim, Eim) = acc
        if fold_re != 0.0:
            ft, fe = scalar_triple(fold_re, device=device)
            tre, Ere = aligned_add(tre, Ere, tf32x3.mul(S, ft), E + fe)
        if fold_im != 0.0:
            ft, fe = scalar_triple(fold_im, device=device)
            tim, Eim = aligned_add(tim, Eim, tf32x3.mul(S, ft), E + fe)
        return (tre, Ere), (tim, Eim)

    acc_re = init_part(c_re)
    acc_im = init_part(c_im)
    if beta != 0 and beta != 1:
        # (re + i*im) * beta
        br, bi = beta.real, beta.imag
        tre, Ere = acc_re
        tim, Eim = acc_im
        acc = (empty(), empty())
        acc = cmul_fold(acc, br, bi, tre, Ere)
        acc = cmul_fold(acc, -bi, br, tim, Eim)
        acc_re, acc_im = acc

    for (ap, bp), (S, E) in zip(ZGEMM_PASSES, SEs):
        if ap == 0 and bp == 0:
            fold = alpha
        elif ap == 1 and bp == 1:
            fold = -alpha
        else:
            fold = complex(-alpha.imag, alpha.real)
        acc_re, acc_im = cmul_fold((acc_re, acc_im), fold.real, fold.imag, S, E)

    return pack_f64(*acc_re), pack_f64(*acc_im)


def _zpasses(a_planes, b_planes, num_split: int, bb: int, k: int, b_kmajor: bool = False):
    """(S, E) of every pass of :data:`ZGEMM_PASSES`; ``a_planes`` and
    ``b_planes`` map 0/1 (real/imag) to (digits, pexp), B's planes k-major
    where ``b_kmajor`` (as the engine splits them: each B part is laid out
    once and read by two passes as it is)."""
    shift = acc_shift(num_split, bb)
    SEs = []
    for ap, bp in ZGEMM_PASSES:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        SEs.append((recombine(da, db, num_split, bb, k, b_kmajor), Exponents(pa, pb, shift)))
    return SEs


def _zsplit(x_re, x_im, num_split: int, bb: int, kp: int, cols: bool):
    """The k-major planes of a complex operand's two parts: 0/1 (real/imag)
    to (digits, pexp); ``cols`` for the B operand."""
    split = split_f64_cols if cols else split_f64
    return {0: split(x_re, num_split, bb, kp), 1: split(x_im, num_split, bb, kp)}


def _zgemm_core(a_re, a_im, b_re, b_im, num_split: int, alpha: complex, beta: complex,
                c_re=None, c_im=None):
    """Complex engine core on one device: four plane splits, four
    recombinations, one fold; on a batch [B, m, k] @ [B, k, n] as many
    launches, the fold running over the [B*m, n] view (it is elementwise)."""
    k = a_re.shape[-1]
    shape = (*a_re.shape[:-1], b_re.shape[-1])
    bb = bits_per_int8(k)
    kp = padded_k(k)
    a_planes = _zsplit(a_re, a_im, num_split, bb, kp, cols=False)
    b_planes = _zsplit(b_re, b_im, num_split, bb, kp, cols=True)
    SEs = _zpasses(a_planes, b_planes, num_split, bb, k, b_kmajor=True)
    n = shape[-1]
    rows = lambda x: None if x is None else x.reshape(-1, n)  # noqa: E731
    SEs = [(tuple(map(rows, S)), E) for S, E in SEs]
    re, im = _zfold_passes(SEs, SEs[0][0][0].shape[0], n, alpha, beta, rows(c_re), rows(c_im),
                           a_re.device)
    return re.reshape(shape), im.reshape(shape)


def _zgemm_core_nchunked(a_re, a_im, b_re, b_im, num_split: int, n_chunks: int,
                         alpha: complex, beta: complex, c_re=None, c_im=None):
    """Column-panel-chunked 4-pass complex engine (bitwise identical to
    :func:`_zgemm_core`): A's two plane splits happen once; each B column
    panel runs the four recombinations and the complex fold locally (the
    fold is elementwise, so chunking columns is exact)."""
    m, k = a_re.shape
    n = b_re.shape[1]
    if n == 0:
        return _zgemm_core(a_re, a_im, b_re, b_im, num_split, alpha, beta, c_re, c_im)
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    kp = padded_k(k)
    a_planes = _zsplit(a_re, a_im, num_split, bb, kp, cols=False)
    out_re = torch.empty((m, n), dtype=torch.float64, device=a_re.device)
    out_im = torch.empty((m, n), dtype=torch.float64, device=a_re.device)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        b_planes = _zsplit(b_re[:, j0:j1], b_im[:, j0:j1], num_split, bb, kp, cols=True)
        SEs = _zpasses(a_planes, b_planes, num_split, bb, k, b_kmajor=True)
        cr = c_re[:, j0:j1] if c_re is not None else None
        ci = c_im[:, j0:j1] if c_im is not None else None
        _zfold_passes(SEs, m, j1 - j0, alpha, beta, cr, ci, a_re.device,
                      (out_re[:, j0:j1], out_im[:, j0:j1]))
    return out_re, out_im


def zgemm_f64(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    num_split: int,
    alpha: complex = 1.0 + 0j,
    beta: complex = 0.0 + 0j,
    c_re: Optional[torch.Tensor] = None,
    c_im: Optional[torch.Tensor] = None,
    n_chunks: Optional[int] = None,
):
    """Emulated complex FP64 GEMM (4-pass real engine) on float64 planes:
    ``(re, im) = alpha * (a @ b) + beta * c`` with ``a = a_re + i a_im``
    [m, k], ``b = b_re + i b_im`` [k, n] and ``c = c_re + i c_im`` [m, n],
    all on one device.  Returns the (re, im) float64 planes.

    Like :func:`gemm_f64`, ``n_chunks=None`` auto-selects column-panel
    streaming from the working-set estimate; chunked output is bitwise
    identical.
    """
    planes = [a_re, a_im, b_re, b_im] + [x for x in (c_re, c_im) if x is not None]
    if any(x.dtype != torch.float64 or x.dim() != 2 for x in planes):
        raise TypeError("zgemm_f64 takes 2-D float64 planes")
    if any(x.device != a_re.device for x in planes):
        raise ValueError("all planes must lie on one device")
    if a_im.shape != a_re.shape or b_im.shape != b_re.shape or a_re.shape[1] != b_re.shape[0]:
        raise ValueError(f"shape mismatch: {tuple(a_re.shape)} @ {tuple(b_re.shape)}")
    if a_re.shape[1] > 0 and bits_per_int8(a_re.shape[1]) <= 0:
        raise ValueError(f"k={a_re.shape[1]} too large for int8 emulation")
    m, k = a_re.shape
    n = b_re.shape[1]
    if k == 0:
        return _zk0_result(complex(beta), c_re, c_im, (m, n), a_re.device)
    a_re, a_im, b_re, b_im = (x.contiguous() for x in (a_re, a_im, b_re, b_im))
    if n_chunks is None:
        n_chunks = auto_n_chunks(m, n, k, num_split, complex_=True, device=a_re.device)
    args = (complex(alpha), complex(beta), c_re, c_im)
    if n_chunks > 1:
        return _zgemm_core_nchunked(a_re, a_im, b_re, b_im, num_split, n_chunks, *args)
    return _zgemm_core(a_re, a_im, b_re, b_im, num_split, *args)


# ---------------------------------------------------------------------------
# Batched engine: one launch of each kernel per sub-batch.
# ---------------------------------------------------------------------------


def _sub_batches(bsz: int, m: int, n: int, k: int, num_split: int, complex_: bool, device):
    """Slices of a batch of ``bsz`` products, each run as one launch of each
    kernel: as many matrices as :func:`~ozimmu_tpu_torch.schedule.hbm_budget_bytes`
    holds at one matrix's working set (the 2-D engine's model at one
    panel) plus its epilogue's temporaries (none on a CUDA device, at least
    one matrix).  None where a single matrix needs column panels: that
    batch runs matrix by matrix through the 2-D engine and its panels."""
    if auto_n_chunks(m, n, k, num_split, complex_, device=device) > 1:
        return None
    temps = _temp_bytes(complex_, device) * m * n
    per = working_set_bytes_chunked(m, n, k, num_split, 1, complex_) + temps
    step = max(1, min(bsz, hbm_budget_bytes(device) // per))
    return [slice(i, min(i + step, bsz)) for i in range(0, bsz, step)]


def _check_batch(ops, cs, what: str) -> None:
    """Operands [B, m, k] and [B, k, n] (``ops``: the A's then the B's, two
    for complex planes), ``cs`` [B, m, n] or None, float64 on one device."""
    a, b = ops[0], ops[-1]
    if any(x.dim() != 3 for x in ops) or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1] \
            or any(x.shape != ops[0].shape for x in ops[:len(ops) // 2]) \
            or any(x.shape != b.shape for x in ops[len(ops) // 2:]):
        raise ValueError(f"{what}: batched shape mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    want = (a.shape[0], a.shape[1], b.shape[2])
    if any(x is not None and tuple(x.shape) != want for x in cs):
        raise ValueError(f"{what}: c must have shape {want}")
    if any(x.dtype != torch.float64 for x in (*ops, *(c for c in cs if c is not None))):
        raise TypeError(f"{what} takes float64 tensors")
    if any(x.device != a.device for x in (*ops, *(c for c in cs if c is not None))):
        raise ValueError(f"{what}: all operands must lie on one device")
    if a.shape[2] > 0 and bits_per_int8(a.shape[2]) <= 0:
        raise ValueError(f"k={a.shape[2]} too large for int8 emulation")


def gemm_f64_batched(
    a: torch.Tensor,
    b: torch.Tensor,
    num_split: int,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``alpha * (a[i] @ b[i]) + beta * c[i]`` for float64 a [B, m, k],
    b [B, k, n] and c [B, m, n] on one device, each matrix bitwise equal to
    :func:`gemm_f64` on it alone.

    One split of each operand, one recombination and one epilogue for as
    many matrices as the memory budget holds (:func:`_sub_batches`): on a
    CUDA device each kernel launches once per sub-batch.  A batch whose
    single matrix needs column panels runs matrix by matrix."""
    _check_batch((a, b), (c,), "gemm_f64_batched")
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    bsz, m, k = a.shape
    n = b.shape[2]
    alpha, beta = float(alpha), float(beta)
    if k == 0:
        return _k0_result(beta, c, (bsz, m, n), a.device)
    a, b = a.contiguous(), b.contiguous()
    parts = _sub_batches(bsz, m, n, k, num_split, False, a.device)

    def one(s, core):
        return core(a[s], b[s], num_split, alpha, beta, None if c is None else c[s])

    if parts is not None and len(parts) == 1:
        return one(parts[0], _gemm_core)
    out = torch.empty((bsz, m, n), dtype=torch.float64, device=a.device)
    core = gemm_f64 if parts is None else _gemm_core
    for s in range(bsz) if parts is None else parts:
        out[s] = one(s, core)
    return out


def zgemm_f64_batched(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    b_re: torch.Tensor,
    b_im: torch.Tensor,
    num_split: int,
    alpha: complex = 1.0 + 0j,
    beta: complex = 0.0 + 0j,
    c_re: Optional[torch.Tensor] = None,
    c_im: Optional[torch.Tensor] = None,
):
    """The complex batch of :func:`gemm_f64_batched` on float64 planes
    [B, m, k], [B, k, n] (and c [B, m, n]), each matrix bitwise equal to
    :func:`zgemm_f64` on it alone: four plane splits and four
    recombinations (one per entry of :data:`ZGEMM_PASSES`) per sub-batch.
    Returns the (re, im) float64 planes [B, m, n]."""
    _check_batch((a_re, a_im, b_re, b_im), (c_re, c_im), "zgemm_f64_batched")
    bsz, m, k = a_re.shape
    n = b_re.shape[2]
    alpha, beta = complex(alpha), complex(beta)
    if k == 0:
        return _zk0_result(beta, c_re, c_im, (bsz, m, n), a_re.device)
    a_re, a_im, b_re, b_im = (x.contiguous() for x in (a_re, a_im, b_re, b_im))
    parts = _sub_batches(bsz, m, n, k, num_split, True, a_re.device)

    def one(s, core):
        cs = [None if x is None else x[s] for x in (c_re, c_im)]
        return core(a_re[s], a_im[s], b_re[s], b_im[s], num_split, alpha, beta, *cs)

    if parts is not None and len(parts) == 1:
        return one(parts[0], _zgemm_core)
    out_re = torch.empty((bsz, m, n), dtype=torch.float64, device=a_re.device)
    out_im = torch.empty_like(out_re)
    core = zgemm_f64 if parts is None else _zgemm_core
    for s in range(bsz) if parts is None else parts:
        out_re[s], out_im[s] = one(s, core)
    return out_re, out_im
