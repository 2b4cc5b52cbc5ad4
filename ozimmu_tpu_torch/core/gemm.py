"""The GEMM engine: split -> recombination -> exact epilogue.

Port of ``ozimmu_tpu.core.gemm``, the equivalent of the reference
orchestration layer (src/gemm.cu:344-521 ``gemm_int8<double>`` and
``gemm_int8<cuDoubleComplex>``, the 4-pass complex engine):

  * equal-weight slice pairs are summed in int32 before any float work
    (ops/recombine.py);
  * the epilogue (alpha/beta folding, reference gemm.cu:124-239) runs in
    triple-f32 extended precision with a single final rounding.

Operands are float64 tensors; every step runs on the operands' device.
On a CUDA device the split and the recombination are the hand-written
kernels (ops/split_cuda.py, ops/recombine_cuda.py); on the CPU, their
plain PyTorch versions.

Layout contract: row-major logical matrices.  ``gemm_f64(a, b)`` computes
``alpha * (a @ b) + beta * c`` for a [m, k] and b [k, n]; ``zgemm_f64``
does the same on the real and imaginary float64 planes of complex
operands.  Transpose flags are applied by the public API (core/api.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import tf32x3
from ..ops.pack import aligned_add, pack_f64, scalar_triple, unpack_f64
from ..ops.recombine import acc_shift, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import auto_n_chunks, bits_per_int8, epilogue_block_bytes

#: live temporaries per output element of one epilogue block, an upper
#: estimate that sets the block height: HPL's first trailing update, with
#: beta * c, peaked at 243.7 B per output element unblocked on an H100,
#: the 24 B of S, E and the output included (tools/torch_ab.py, PERF.md);
#: the complex fold keeps two accumulators and folds four passes
_EPILOGUE_TEMP_BYTES = 256
_ZFOLD_TEMP_BYTES = 512


def _row_blocks(m: int, n: int, temp_bytes: int, device):
    """Row ranges ``slice(r0, r1)`` covering an m x n output, each short
    enough that ``temp_bytes`` per element stay within
    :func:`~ozimmu_tpu_torch.schedule.epilogue_block_bytes` of ``device``."""
    rows = max(1, epilogue_block_bytes(device) // max(1, temp_bytes * n))
    return [slice(r0, min(r0 + rows, m)) for r0 in range(0, m, rows)]


def _epilogue_SE(S, E, alpha: float, beta: float, c: Optional[torch.Tensor]) -> torch.Tensor:
    """``alpha * (S * 2^E) + beta * c`` in extended precision, rounded to
    f64 once (reference axby, gemm.cu:124-158).

    Where the eager passes' temporaries would not fit what the memory
    budget leaves, runs over row blocks into one float64 output: every
    pass is elementwise, so the blocking leaves the bits alone (the
    working-set model counts the output, S and E)."""
    if beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")
    m, n = E.shape
    blocks = _row_blocks(m, n, _EPILOGUE_TEMP_BYTES, E.device)
    if len(blocks) == 1:
        return _epilogue_block(S, E, alpha, beta, c)
    out = torch.empty((m, n), dtype=torch.float64, device=E.device)
    for rows in blocks:
        out[rows] = _epilogue_block(tuple(s[rows] for s in S), E[rows], alpha, beta,
                                    None if c is None else c[rows])
    return out


def _epilogue_block(S, E, alpha: float, beta: float, c: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`_epilogue_SE` on one block of rows."""
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


def _exponent_plane(pa: torch.Tensor, pb: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 ``pa[:, None] + pb[None, :] - shift`` (int32 so that the
    ZERO_ROW_PEXP sentinel arithmetic matches the JAX package's)."""
    return (pa[:, None] + pb[None, :] - shift).to(torch.int32)


def _gemm_core(a, b, num_split: int, alpha: float, beta: float, c=None) -> torch.Tensor:
    """Real-valued engine core on one device."""
    k = a.shape[1]
    bb = bits_per_int8(k)
    da, pa = split_f64(a, num_split, bb)
    db, pb = split_f64_cols(b, num_split, bb)
    S = recombine(da, db, num_split, bb, k)
    E = _exponent_plane(pa, pb, acc_shift(num_split, bb))
    return _epilogue_SE(S, E, alpha, beta, c)


def _gemm_core_nchunked(a, b, num_split: int, n_chunks: int, alpha: float = 1.0,
                        beta: float = 0.0, c=None) -> torch.Tensor:
    """Column-panel-chunked engine: split A once, stream B in n panels.

    Bitwise-identical to :func:`_gemm_core` (B's split is per-column
    independent, the recombination sees the full k, and the epilogue is
    elementwise), but peak memory for the B planes / int32 partials /
    triple-f32 accumulator drops by ~n_chunks.  Any ``n`` (the last panel
    is simply narrower).
    """
    k = a.shape[1]
    n = b.shape[1]
    if n == 0:
        return _gemm_core(a, b, num_split, alpha, beta, c)
    w = -(-n // n_chunks)
    bb = bits_per_int8(k)
    shift = acc_shift(num_split, bb)
    da, pa = split_f64(a, num_split, bb)
    out = torch.empty((a.shape[0], n), dtype=torch.float64, device=a.device)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        db, pb = split_f64_cols(b[:, j0:j1].contiguous(), num_split, bb)
        S = recombine(da, db, num_split, bb, k)
        E = _exponent_plane(pa, pb, shift)
        cj = c[:, j0:j1] if c is not None else None
        out[:, j0:j1] = _epilogue_SE(S, E, alpha, beta, cj)
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
    if bits_per_int8(a.shape[1]) <= 0:
        raise ValueError(f"k={a.shape[1]} too large for int8 emulation")
    if b.device != a.device or (c is not None and c.device != a.device):
        raise ValueError("a, b and c must lie on one device")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
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


def _zfold_passes(SEs, m: int, n: int, alpha: complex, beta: complex, c_re, c_im, device):
    """Fold the four pass results into the complex output (shared by the
    fused `_zgemm_core` and the staged/profiled path in core.api).

    ``SEs`` lists (S, E) per entry of :data:`ZGEMM_PASSES`.  Fold factors
    (reference gemm.cu:479-518): re*re -> +alpha, im*im -> -alpha, cross
    terms -> i*alpha; C is pre-scaled by beta (init_c_complex,
    gemm.cu:199-239).  Returns the (re, im) float64 planes, written over
    row blocks as :func:`_epilogue_SE` writes its output.
    """
    blocks = _row_blocks(m, n, _ZFOLD_TEMP_BYTES, device)
    if len(blocks) == 1:
        return _zfold_block(SEs, m, n, alpha, beta, c_re, c_im, device)
    out_re = torch.empty((m, n), dtype=torch.float64, device=device)
    out_im = torch.empty((m, n), dtype=torch.float64, device=device)
    for rows in blocks:
        block = [(tuple(s[rows] for s in S), E[rows]) for S, E in SEs]
        out_re[rows], out_im[rows] = _zfold_block(
            block, rows.stop - rows.start, n, alpha, beta,
            None if c_re is None else c_re[rows], None if c_im is None else c_im[rows], device)
    return out_re, out_im


def _zfold_block(SEs, m: int, n: int, alpha: complex, beta: complex, c_re, c_im, device):
    """:func:`_zfold_passes` on one block of rows."""

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


def _zpasses(a_planes, b_planes, num_split: int, bb: int, k: int):
    """(S, E) of every pass of :data:`ZGEMM_PASSES`; ``a_planes`` and
    ``b_planes`` map 0/1 (real/imag) to (digits, pexp)."""
    shift = acc_shift(num_split, bb)
    SEs = []
    for ap, bp in ZGEMM_PASSES:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        SEs.append((recombine(da, db, num_split, bb, k), _exponent_plane(pa, pb, shift)))
    return SEs


def _zgemm_core(a_re, a_im, b_re, b_im, num_split: int, alpha: complex, beta: complex,
                c_re=None, c_im=None):
    """Complex engine core on one device: four plane splits, four
    recombinations, one fold."""
    m, k = a_re.shape
    n = b_re.shape[1]
    bb = bits_per_int8(k)
    a_planes = {0: split_f64(a_re, num_split, bb), 1: split_f64(a_im, num_split, bb)}
    b_planes = {0: split_f64_cols(b_re, num_split, bb), 1: split_f64_cols(b_im, num_split, bb)}
    SEs = _zpasses(a_planes, b_planes, num_split, bb, k)
    return _zfold_passes(SEs, m, n, alpha, beta, c_re, c_im, a_re.device)


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
    a_planes = {0: split_f64(a_re, num_split, bb), 1: split_f64(a_im, num_split, bb)}
    out_re = torch.empty((m, n), dtype=torch.float64, device=a_re.device)
    out_im = torch.empty((m, n), dtype=torch.float64, device=a_re.device)
    for j0 in range(0, n, w):
        j1 = min(j0 + w, n)
        b_planes = {
            0: split_f64_cols(b_re[:, j0:j1].contiguous(), num_split, bb),
            1: split_f64_cols(b_im[:, j0:j1].contiguous(), num_split, bb),
        }
        SEs = _zpasses(a_planes, b_planes, num_split, bb, k)
        cr = c_re[:, j0:j1] if c_re is not None else None
        ci = c_im[:, j0:j1] if c_im is not None else None
        out_re[:, j0:j1], out_im[:, j0:j1] = _zfold_passes(
            SEs, m, j1 - j0, alpha, beta, cr, ci, a_re.device)
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
    if bits_per_int8(a_re.shape[1]) <= 0:
        raise ValueError(f"k={a_re.shape[1]} too large for int8 emulation")
    a_re, a_im, b_re, b_im = (x.contiguous() for x in (a_re, a_im, b_re, b_im))
    m, k = a_re.shape
    n = b_re.shape[1]
    if n_chunks is None:
        n_chunks = auto_n_chunks(m, n, k, num_split, complex_=True, device=a_re.device)
    args = (complex(alpha), complex(beta), c_re, c_im)
    if n_chunks > 1:
        return _zgemm_core_nchunked(a_re, a_im, b_re, b_im, num_split, n_chunks, *args)
    return _zgemm_core(a_re, a_im, b_re, b_im, num_split, *args)
