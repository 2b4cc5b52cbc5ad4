"""The GEMM engine: split -> recombination -> exact epilogue.

Port of ``ozimmu_tpu.core.gemm``, the equivalent of the reference
orchestration layer (src/gemm.cu:344-521 ``gemm_int8<double>`` and
``gemm_int8<cuDoubleComplex>``, the 4-pass complex engine):

  * equal-weight slice pairs are summed in int32 before any float work
    (ops/recombine.py);
  * the epilogue (alpha/beta folding, reference gemm.cu:124-239) runs in
    triple-f32 extended precision with a single final rounding.

Every int8 product of the package, from any surface (the public API, the
interceptor, ``traced``, the solvers), runs through one loop,
:func:`_loop`: split each part of A once; then for each column panel of
B (one panel as a rule), split each part of B's panel, recombine each
pass (one for real operands, :data:`ZGEMM_PASSES` for complex ones) and
hand the results to the finisher, :func:`_epilogue_SE` or
:func:`_zfold_passes`.  :func:`_run` chooses the column panels and, for a
batch [B, m, k] @ [B, k, n] (each matrix with its own scales, the JAX
package's ``vmap`` of the cores), the sub-batches that each launch every
kernel once.  :func:`_check` makes the operand checks of every entry.

This module also owns the complex layout: a complex128 operand becomes
its contiguous real and imaginary float64 planes (:func:`_planes`), and
the result planes are interleaved again (:func:`_complex_result`), except
in :func:`gemm_int8`'s 2-D products, whose fold reads c's parts as the
views of c and writes the complex128 output itself; and the module
counters of the entries above it (:data:`ZLAYOUT_COPIES`,
:data:`IN_PLACE`, :data:`AUTO_CHOICES`, the replay's).

Operands are float64 tensors (planes); every step runs on the operands'
device.  On a CUDA device the split, the recombination and the epilogue
(or the complex fold) are the hand-written kernels (ops/split_cuda.py,
ops/recombine_cuda.py, ops/epilogue_cuda.py), one launch of the epilogue
per output or column panel; on the CPU, their plain PyTorch versions.

BLAS defines a product with k = 0 as ``C <- beta * C``: the engine returns
that, or zeros where beta == 0 or c is None (c is then never read), and
launches nothing.

Layout contract: row-major logical matrices.  :func:`gemm_int8` computes
``alpha * (a @ b) + beta * c`` on float64 or complex128 tensors, 2-D or
batched, a 2-D product into a new tensor or the caller's ``out`` (a window
of a larger matrix, or c itself); ``gemm_f64`` / ``gemm_f64_batched`` on
float64 tensors and ``zgemm_f64`` / ``zgemm_f64_batched`` on the real and
imaginary float64 planes of complex operands are the JAX package's
entries.  Transpose
flags are applied by the public API (core/api.py).
"""

from __future__ import annotations

import atexit
import contextlib
import struct
import threading
from collections import Counter, OrderedDict
from typing import NamedTuple, Optional

import torch

from .. import native
from ..ops import tf32x3
from ..ops.pack import aligned_add, pack_f64, scalar_triple, unpack_f64
from ..ops.recombine import acc_shift, padded_k, recombine
from ..ops.split import split_f64, split_f64_cols
from ..schedule import (
    REPLAY_MAX_BYTES, REPLAY_MAX_WORK, auto_n_chunks, bits_per_int8, epilogue_block_bytes,
    hbm_budget_bytes, replay_bytes, replay_cache_bytes, schedule_flops,
    working_set_bytes_chunked,
)
from ..utils.log import error
from ..utils.profiling import span

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
    with span("oz.epilogue"):
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


def _k0_result(beta, C, shape, device) -> tuple:
    """A product with k = 0 (BLAS: ``C <- beta * C``) by parts: ``C`` holds
    c (real) or its (re, im) planes, each None where absent.  Real:
    ``beta * c``, one IEEE float64 multiply per element.  Complex:
    ``re = br*cr - bi*ci``, ``im = br*ci + bi*cr``, each an IEEE float64
    operation (no fused multiply-add, so the bits are the same on every
    device).  Zeros where beta == 0 or c is None, c then never read."""
    def zeros():
        return torch.zeros(shape, dtype=torch.float64, device=device)

    if beta == 0 or all(x is None for x in C):
        return tuple(zeros() for _ in C)
    if len(C) == 1:
        return (beta * C[0],)
    cr, ci = (x if x is not None else zeros() for x in C)
    br, bi = beta.real, beta.imag
    return br * cr - bi * ci, br * ci + bi * cr


def _exponent_plane(pa: torch.Tensor, pb: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 ``pa[:, None] + pb[None, :] - shift``, matrix by matrix for a
    batch pa [B, m], pb [B, n] (int32 so that the ZERO_ROW_PEXP sentinel
    arithmetic matches the JAX package's)."""
    return (pa[..., :, None] + pb[..., None, :] - shift).to(torch.int32)


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
    """Fold the four pass results into the complex output (the finisher of
    :func:`_loop`'s complex products, and of ``parallel``'s).

    ``SEs`` lists (S, E) per entry of :data:`ZGEMM_PASSES`, S [m, n] and E
    :class:`Exponents` (or, on the CPU, a plane; a batch's S by its
    [B*m, n] rows, its Exponents [B, m] and [B, n]).  Fold factors
    (reference gemm.cu:479-518): re*re -> +alpha, im*im -> -alpha, cross
    terms -> i*alpha; C is pre-scaled by beta (init_c_complex,
    gemm.cu:199-239).  Returns the (re, im) float64 planes, new or written
    into ``out`` (a pair [m, n], e.g. column panels of wider planes), or
    ``out`` itself where it is a complex128 [m, n] tensor, written
    interleaved (its rows contiguous; c's parts may be its own views).  On
    a CUDA device, one launch of the fold kernel (ops/epilogue_cuda.py); on
    the CPU, the plain version :func:`_zfold_block` over row blocks, as
    :func:`_epilogue_SE` runs its plain version, into
    ``torch.view_as_real``'s views of a complex128 ``out``.
    """
    with span("oz.epilogue"):
        if _on_cuda(device):
            from ..ops.epilogue_cuda import zfold

            return zfold(SEs, alpha, beta, c_re, c_im, out)
        SEs = [(S, _as_plane(E).reshape(m, n)) for S, E in SEs]
        blocks = _row_blocks(m, n, _ZFOLD_TEMP_BYTES, device)
        if len(blocks) == 1 and out is None:
            return _zfold_block(SEs, m, n, alpha, beta, c_re, c_im, device)
        if out is None:
            out = tuple(torch.empty((m, n), dtype=torch.float64, device=device) for _ in range(2))
        out_re, out_im = _part_views(out)
        for rows in blocks:
            block = [(tuple(s[rows] for s in S), E[rows]) for S, E in SEs]
            out_re[rows], out_im[rows] = _zfold_block(
                block, rows.stop - rows.start, n, alpha, beta,
                None if c_re is None else c_re[rows], None if c_im is None else c_im[rows], device)
        return out


def _part_views(out):
    """The float64 parts of an output: a tuple of parts as it is, or the
    (re, im) views of a complex128 tensor (stride 2)."""
    return torch.view_as_real(out).unbind(-1) if isinstance(out, torch.Tensor) else out


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


# ---------------------------------------------------------------------------
# Complex layout: complex128 tensors <-> contiguous float64 planes.
# ---------------------------------------------------------------------------

#: copies made by the complex layout: one for each float64 plane made from
#: a complex operand (:func:`_planes`) and one for each interleave of a
#: result (:func:`_complex_result`); 7 a complex GEMM of the public API
#: with c, 5 without; 4 a 2-D complex :func:`gemm_int8` (A's and B's planes)
ZLAYOUT_COPIES = 0

#: products finished into a caller's ``out`` (:func:`gemm_int8`), by the
#: dtype's name (``"float64"``, ``"complex128"``): one a product
IN_PLACE: Counter = Counter()

#: the modes that AUTO chose, by the mode's value: one for each AUTO
#: decision of the public API's real, complex, batched real and batched
#: complex entries and of the interceptor's 2-D route (``core.api._auto``,
#: inside the span ``oz.auto``); a fallback counts as the mode it falls
#: back to, ``"dgemm"`` by default
AUTO_CHOICES: Counter = Counter()


def _planes(x: torch.Tensor):
    """Contiguous real and imaginary float64 planes of a complex tensor
    (``x.real`` / ``x.imag`` are stride-2 views, which the split kernel
    does not take)."""
    global ZLAYOUT_COPIES
    with span("oz.zlayout"):
        ZLAYOUT_COPIES += 2
        return x.real.contiguous(), x.imag.contiguous()


def _complex_result(re: torch.Tensor, im: torch.Tensor, is_np: bool):
    """The complex result of its planes: a complex128 tensor where they lie,
    or, with ``is_np``, a numpy complex128 array."""
    global ZLAYOUT_COPIES
    with span("oz.zlayout"):
        ZLAYOUT_COPIES += 1
        if is_np:
            # the JAX package's construction (signed zeros follow numpy's
            # complex arithmetic), so the numpy results match it bit for bit
            return re.cpu().numpy() + 1j * im.cpu().numpy()
        return torch.complex(re, im)


# ---------------------------------------------------------------------------
# The loop: every int8 product on one device.
# ---------------------------------------------------------------------------

#: the one pass of a real product: A's part 0 with B's part 0
_REAL_PASSES = ((0, 0),)

_NO_PHASE = contextlib.nullcontext()


def _no_phase(name: str):
    return _NO_PHASE


def _recombine_passes(a_planes, b_planes, num_split: int, bb: int, k: int,
                      b_kmajor: bool = False, passes=ZGEMM_PASSES):
    """(S, E) of every pass (A-part, B-part) of ``passes``; ``a_planes``
    and ``b_planes`` map 0/1 (real/imag) to (digits, pexp), B's planes
    k-major where ``b_kmajor`` (as the engine splits them: each B part is
    laid out once and read by two complex passes as it is)."""
    shift = acc_shift(num_split, bb)
    SEs = []
    for ap, bp in passes:
        da, pa = a_planes[ap]
        db, pb = b_planes[bp]
        SEs.append((recombine(da, db, num_split, bb, k, b_kmajor), Exponents(pa, pb, shift)))
    return SEs


def _finish(SEs, C, alpha, beta, out):
    """The finisher: the epilogue of a real product's one pass, or the fold
    of a complex product's four; results by parts, new or written into
    ``out`` (the parts of an output's column panel, or a complex128 panel,
    which the fold writes interleaved and returns).  A complex batch folds
    over its [B*m, n] rows (the fold is elementwise)."""
    if len(SEs) == 1:
        ((S, E),) = SEs
        return (_epilogue_SE(S, E, alpha, beta, C[0], None if out is None else out[0]),)
    S0 = SEs[0][0][0]
    if S0.dim() == 2:
        return _zfold_passes(SEs, *S0.shape, alpha, beta, *C, S0.device, out)
    shape, n = S0.shape, S0.shape[-1]
    rows = lambda x: None if x is None else x.reshape(-1, n)  # noqa: E731
    SEs = [(tuple(map(rows, S)), E) for S, E in SEs]
    re, im = _zfold_passes(SEs, shape[0] * shape[1], n, alpha, beta, *map(rows, C), S0.device)
    return re.reshape(shape), im.reshape(shape)


def _loop(A, B, C, num_split: int, alpha, beta, n_chunks: int, phase=_no_phase, out=None):
    """The int8 product ``alpha * (a @ b) + beta * c`` by parts (one for a
    real product, (re, im) planes for a complex one), on contiguous A parts
    [m, k] or [B, m, k], B parts [k, n] or [B, k, n], and C's parts (None
    where absent, any strides); returns the output's parts, new, or
    ``out`` written in place: a 2-D product's parts (rows contiguous), or
    for a complex one a complex128 [m, n] tensor that the fold writes
    interleaved.  ``out`` may be c itself (each element reads c before it
    is written), and shares no storage with A or B.

    A's parts are split once.  Then, for each of ``n_chunks`` column panels
    of B (the last narrower; one panel for a batch): split B's parts where
    they lie (the kernels read a panel through its row stride) straight
    into k-major planes, recombine every pass, and finish into the panel's
    columns of the output.  Chunked and unchunked results are bitwise
    identical: B's split is per column, the recombination sees the full k
    and the finisher is elementwise.  ``phase(name)`` is a context around
    each step (the handle's phase profiler, or nothing)."""
    k = A[0].shape[-1]
    n = B[0].shape[-1]
    bb = bits_per_int8(k)
    if bb <= 0:
        raise ValueError(f"k={k} exceeds the int8 emulation bound (needs k*2^(2b) <= 2^31);"
                         " shard or chunk the contraction")
    kp = padded_k(k)
    passes = ZGEMM_PASSES if len(A) == 2 else _REAL_PASSES
    with phase("split_A"):
        a_planes = [split_f64(x, num_split, bb, kp) for x in A]
    if n_chunks == 1 or n == 0:
        panels = ((B, C, out),)
    else:
        w = -(-n // n_chunks)
        if out is None:
            out = tuple(torch.empty((A[0].shape[0], n), dtype=torch.float64, device=A[0].device)
                        for _ in A)
        cols = lambda X, j: [None if x is None else x[:, j:j + w] for x in X]  # noqa: E731
        panels = ((cols(B, j), cols(C, j),
                   out[:, j:j + w] if isinstance(out, torch.Tensor) else tuple(cols(out, j)))
                  for j in range(0, n, w))
    for Bp, Cp, out_p in panels:
        with phase("split_B"):
            b_planes = [split_f64_cols(x, num_split, bb, kp) for x in Bp]
        with phase("int8tc+accumulate_in_f64"):
            SEs = _recombine_passes(a_planes, b_planes, num_split, bb, k, True, passes)
        with phase("copy_result"):
            got = _finish(SEs, Cp, alpha, beta, out_p)
    return got if out is None else out


def _sub_batches(bsz: int, m: int, n: int, k: int, num_split: int, complex_: bool, device):
    """Slices of a batch of ``bsz`` products, each run as one launch of each
    kernel: as many matrices as :func:`~ozimmu_tpu_torch.schedule.hbm_budget_bytes`
    holds at one matrix's working set (the 2-D engine's model at one
    panel) plus its epilogue's temporaries (none on a CUDA device, at least
    one matrix).  None where a single matrix needs column panels: that
    batch runs matrix by matrix, each in its panels."""
    if auto_n_chunks(m, n, k, num_split, complex_, device=device) > 1:
        return None
    temps = _temp_bytes(complex_, device) * m * n
    per = working_set_bytes_chunked(m, n, k, num_split, 1, complex_) + temps
    step = max(1, min(bsz, hbm_budget_bytes(device) // per))
    return [slice(i, min(i + step, bsz)) for i in range(0, bsz, step)]


# ---------------------------------------------------------------------------
# Replay: a small product's kernel chain, captured once per call signature
# and replayed as one CUDA graph.
# ---------------------------------------------------------------------------

#: calls of :func:`_run` since the process started that captured their
#: signature's chain (and replayed it at once), that replayed a chain (the
#: capturing calls included), and that ran eagerly under the cut: a
#: signature's first call, or one whose chain is eager for good because
#: its capture failed (:data:`CAPTURE_FAILURES` counts those failures) or
#: would not fit the cache's cap
CAPTURES = 0
REPLAYS = 0
EAGER_SMALL = 0
CAPTURE_FAILURES = 0

#: the signatures that :class:`ReplayCache` remembers, the least recently
#: used forgotten first
_SIGNATURES = 1024

#: a signature's state in :class:`ReplayCache` beside a captured chain:
#: called once (the next call captures), or eager for good
_SEEN, _EAGER = "seen", "eager"


def replays(m: int, n: int, k: int, num_split: int, complex_: bool = False) -> bool:
    """Whether a product [m, k] @ [k, n] is small enough for :func:`_run`
    to replay its captured chain (where it is a 2-D product in one column
    panel, with no phase profiler, on a device that can capture now:
    :func:`_run` checks those): int8 work at most
    :data:`~ozimmu_tpu_torch.schedule.REPLAY_MAX_WORK` and an entry, c's
    copies left out, of at most ``REPLAY_MAX_BYTES``."""
    return (schedule_flops(num_split, m, n, k, complex_) <= REPLAY_MAX_WORK
            and replay_bytes(m, n, k, num_split, complex_) <= REPLAY_MAX_BYTES)


def _graphs(dev) -> bool:
    """Whether a chain on ``dev`` can be captured now: a CUDA device whose
    current stream is not capturing already (a user's graph,
    ``torch.compile``'s reduce-overhead mode: their capture takes the
    eager chain as it is)."""
    return dev.type == "cuda" and not torch.cuda.is_current_stream_capturing()


def _scalar_bits(x) -> bytes:
    """A float or complex scalar's float64 bits, real and imaginary: a key
    that tells -0.0 from 0.0 (the epilogue's signed zeros do) and finds a
    NaN again."""
    return struct.pack("<2d", x.real, x.imag)


def replay_key(parts: int, m: int, n: int, k: int, num_split: int, alpha, beta, c_given,
               device, stream: int, interleaved: bool = False) -> tuple:
    """The signature of a product: everything the chain that :func:`_loop`
    launches depends on.  ``parts`` 1 (real) or 2 (complex), alpha and beta
    as values, ``c_given`` whether each part of c is read, the device, the
    current stream's handle (static buffers are never shared across
    streams) and whether a complex output is one interleaved complex128
    tensor (the fold's other instantiation) rather than two planes."""
    return (parts, m, n, k, num_split, _scalar_bits(alpha), _scalar_bits(beta), tuple(c_given),
            torch.device(device), stream, bool(interleaved))


class _Replay:
    """A captured chain: the graph, the static buffers it reads (A's, B's
    and c's parts; None for a part of c it does not read), its output (the
    parts, or one interleaved complex128 tensor), the tape of the
    wrappers' launches it holds, and the device bytes it holds."""

    def __init__(self, graph, inputs, out, tape, nbytes: int):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.tape, self.nbytes = tape, nbytes
        self.lock = threading.Lock()


class ReplayCache:
    """The signatures met, by key, the least recently used first: each
    :data:`_SEEN`, :data:`_EAGER` or a captured chain (:class:`_Replay`).
    Chains are dropped back to :data:`_SEEN`, the least recently used
    first, while their bytes together pass the cap that :meth:`put` is
    given; signatures beyond :data:`_SIGNATURES` are forgotten, the oldest
    first.  Its methods may be called from several threads."""

    def __init__(self):
        self.states: OrderedDict = OrderedDict()
        self.nbytes = 0
        self.lock = threading.Lock()

    def state(self, key):
        """The state of ``key``, now the most recently used; None where it
        was not met before (it is :data:`_SEEN` now)."""
        with self.lock:
            state = self.states.get(key)
            if state is None:
                self.states[key] = _SEEN
                if len(self.states) > _SIGNATURES:
                    self._set(next(iter(self.states)), None)
            else:
                self.states.move_to_end(key)
            return state

    def put(self, key, state, cap: int) -> None:
        """Set the state of ``key``, then drop the least recently used
        chains until the chains' bytes fit ``cap``."""
        with self.lock:
            self._set(key, state)
            chains = [k for k, s in self.states.items() if isinstance(s, _Replay)]
            for old in chains:
                if self.nbytes <= cap:
                    break
                self._set(old, _SEEN)

    def _set(self, key, state) -> None:
        """Set (None: forget) the state of ``key``, counting chains' bytes."""
        old = self.states.pop(key, None) if state is None else self.states.get(key)
        self.nbytes -= old.nbytes if isinstance(old, _Replay) else 0
        if state is not None:
            self.states[key] = state
            self.nbytes += state.nbytes if isinstance(state, _Replay) else 0

    def clear(self) -> None:
        with self.lock:
            self.states.clear()
            self.nbytes = 0


_CACHE = ReplayCache()
#: one capture at a time in the process (CUDA graphs allow no more)
_CAPTURE_LOCK = threading.Lock()
#: a side stream per device to capture on (the legacy default stream
#: cannot capture)
_CAPTURE_STREAMS: dict = {}


def _capture(A, B, C, num_split: int, alpha, beta, dev, cap: int,
             interleaved: bool = False) -> Optional[_Replay]:
    """Capture :func:`_loop`'s chain on static buffers of A's, B's and C's
    shapes (C's parts None where not read) on a side stream, into a
    complex128 output where ``interleaved``; None where the capture raises
    or the chain's bytes pass ``cap``.  Its bytes are
    the static buffers and the growth of the device's reserved memory
    over the capture: the graph's private pool, as the allocator holds
    it.  The wrappers count the captured launches, which the chain's
    first replay, at once, launches; their tape is kept for each later
    replay to count."""
    global CAPTURE_FAILURES
    inputs = [None if x is None else torch.empty(x.shape, dtype=torch.float64, device=dev)
              for x in (*A, *B, *C)]
    sA, sB, sC = inputs[:len(A)], inputs[len(A):len(A) + len(B)], inputs[len(A) + len(B):]
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        if dev not in _CAPTURE_STREAMS:
            if not _CAPTURE_STREAMS:
                atexit.register(_CACHE.clear)  # the graphs go before the CUDA context
            _CAPTURE_STREAMS[dev] = torch.cuda.Stream(device=dev)
        side, caller = _CAPTURE_STREAMS[dev], torch.cuda.current_stream(dev)
        side.wait_stream(caller)
        reserved = torch.cuda.memory_reserved(dev)
        with native.recording() as tape:
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        out = None
                        if interleaved:
                            out = torch.empty((A[0].shape[0], B[0].shape[1]),
                                              dtype=torch.complex128, device=dev)
                        out = _loop(sA, sB, sC, num_split, alpha, beta, 1, out=out)
                    finally:
                        graph.capture_end()
            except RuntimeError as e:
                CAPTURE_FAILURES += 1
                native.count(tape, -1)
                error(f"replay: the capture of a {A[0].shape[0]}x{B[0].shape[1]}x{A[0].shape[1]} "
                      f"product failed ({e}); it runs eagerly from now on")
                return None
        pool = torch.cuda.memory_reserved(dev) - reserved
        caller.wait_stream(side)
    nbytes = sum(8 * x.numel() for x in inputs if x is not None) + pool
    if nbytes > cap:
        native.count(tape, -1)
        return None
    return _Replay(graph, inputs, out, tape, nbytes)


def _replayed(A, B, C, num_split: int, alpha, beta, out=None):
    """The output's parts by the replay of the signature's captured chain,
    the operands copied into its static buffers and the output cloned
    (the next replay writes over it), or copied into ``out`` (the parts,
    or a complex128 tensor: the chain then folds into an interleaved
    output of its own); the chain is captured at the
    signature's second call, where its estimate (:func:`replay_bytes`)
    fits the cache's cap (:func:`replay_cache_bytes`).  None where the
    call is to run eagerly: the signature's first call, or a signature
    eager for good."""
    global CAPTURES, EAGER_SMALL, REPLAYS
    dev = A[0].device
    (m, k), n = A[0].shape, B[0].shape[1]
    C = [x if beta != 0 else None for x in C]  # c is read only where beta != 0
    interleaved = isinstance(out, torch.Tensor)
    key = replay_key(len(A), m, n, k, num_split, alpha, beta, (x is not None for x in C), dev,
                     torch.cuda.current_stream(dev).cuda_stream, interleaved)
    entry = _CACHE.state(key)
    if entry is None or entry is _EAGER:
        EAGER_SMALL += 1
        return None
    again = 1
    if entry is _SEEN:
        cap = replay_cache_bytes(dev)
        need = replay_bytes(m, n, k, num_split, len(A) == 2, sum(x is not None for x in C))
        entry = (_capture(A, B, C, num_split, alpha, beta, dev, cap, interleaved)
                 if need <= cap else None)
        _CACHE.put(key, entry or _EAGER, cap)
        if entry is None:
            EAGER_SMALL += 1
            return None
        CAPTURES += 1
        again = 0  # the capture counted the launches of this first replay
    with span("oz.replay"), entry.lock, torch.cuda.device(dev):
        for s, x in zip(entry.inputs, (*A, *B, *C)):
            if s is not None:
                s.copy_(x)
        entry.graph.replay()
        if out is None:
            out = tuple(o.clone() for o in entry.out)
        elif interleaved:
            out.copy_(entry.out)
        else:
            for o, x in zip(out, entry.out):
                o.copy_(x)
    native.count(entry.tape, again)
    REPLAYS += 1
    return out


def _run(A, B, C, num_split: int, alpha, beta, n_chunks: Optional[int] = None,
         phase=_no_phase, out=None):
    """The engine on checked operands by parts (see :func:`_loop`), k > 0:
    the span ``oz.engine`` around the loop, run once, or once per
    sub-batch, or around the replay of the product's captured chain (a
    2-D product in one column panel with no phase profiler, on a device
    that can capture now, small enough for :func:`replays`; ``oz.replay``).
    ``n_chunks`` sets a 2-D product's column panels, None choosing them
    from the working-set estimate against the device's memory
    (schedule.auto_n_chunks).  A batch runs in the sub-batches of
    :func:`_sub_batches`, or matrix by matrix where one matrix needs
    column panels.  Returns the output's parts, or a 2-D product's ``out``
    (see :func:`_loop`) written in place."""
    with span("oz.engine"):
        complex_, dev = len(A) == 2, A[0].device
        m, k = A[0].shape[-2:]
        n = B[0].shape[-1]
        batched = A[0].dim() == 3
        if not batched and n_chunks is None:
            n_chunks = auto_n_chunks(m, n, k, num_split, complex_, device=dev)
        if (not batched and n_chunks == 1 and phase is _no_phase and _graphs(dev)
                and replays(m, n, k, num_split, complex_)):
            got = _replayed(A, B, C, num_split, alpha, beta, out)
            if got is not None:
                return got
        A = [x.contiguous() for x in A]
        B = [x.contiguous() for x in B]
        if not batched:
            return _loop(A, B, C, num_split, alpha, beta, n_chunks, phase, out)
        bsz = A[0].shape[0]
        parts = _sub_batches(bsz, m, n, k, num_split, complex_, dev)
        if parts is not None and len(parts) == 1:
            return _loop(A, B, C, num_split, alpha, beta, 1, phase)
        chunks = 1 if parts is not None else auto_n_chunks(m, n, k, num_split, complex_, device=dev)
        out = tuple(torch.empty((bsz, m, n), dtype=torch.float64, device=dev) for _ in A)
        for s in range(bsz) if parts is None else parts:
            pick = lambda X: [None if x is None else x[s] for x in X]  # noqa: E731
            for o, r in zip(out, _loop(pick(A), pick(B), pick(C), num_split, alpha, beta,
                                       chunks, phase)):
                o[s] = r
        return out


# ---------------------------------------------------------------------------
# Entries: the operand checks, k = 0, the layout.
# ---------------------------------------------------------------------------


def _check(A, B, C, beta, batched: bool, dtype=torch.float64) -> None:
    """The operand checks of every entry, on parts: A's [m, k], B's [k, n]
    and C's [m, n] (None where absent), or [B, m, k], [B, k, n] and
    [B, m, n] where ``batched``; all of ``dtype`` on one device, and c
    given where beta != 0.  The k bound is the loop's (:func:`_loop`)."""
    a, b = A[0], B[0]
    sa, sb = a.shape, b.shape
    if len(sa) != (3 if batched else 2) or len(sb) != len(sa) or sa[-1] != sb[-2] \
            or (batched and sa[0] != sb[0]) or A[-1].shape != sa or B[-1].shape != sb:
        what = "batched shape mismatch" if batched else "shape mismatch"
        raise ValueError(f"{what}: {tuple(sa)} @ {tuple(sb)}")
    cs = [x for x in C if x is not None]
    if cs:
        want = (*sa[:-1], sb[-1])
        for x in cs:
            if x.shape != want:
                raise ValueError(f"c has shape {tuple(x.shape)}; c must have shape {want}")
    elif beta != 0:
        raise ValueError("beta != 0 requires c")
    dev = a.device
    for x in (*A, *B, *cs):
        if x.dtype != dtype:
            raise TypeError(f"expected {dtype} operands, got {x.dtype}")
        if x.device != dev:
            raise ValueError("a, b and c must lie on one device")


def _entry(A, B, C, num_split: int, alpha, beta, batched: bool, n_chunks=None, out=None):
    """:func:`_check`, then :func:`_run` or the k = 0 result, by parts or
    into ``out`` (see :func:`_loop`)."""
    _check(A, B, C, beta, batched)
    if A[0].shape[-1] == 0:
        got = _k0_result(beta, C, (*A[0].shape[:-1], B[0].shape[-1]), A[0].device)
        if out is None:
            return got
        for o, x in zip(_part_views(out), got):
            o.copy_(x)
        return out
    return _run(A, B, C, num_split, alpha, beta, n_chunks, out=out)


def _shares_storage(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x.numel() > 0 and y.numel() > 0 and \
        x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()


def _check_out(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: Optional[torch.Tensor]) -> None:
    """The checks of :func:`gemm_int8`'s ``out``: a 2-D product's dtype and
    shape [m, n] on the operands' device, rows contiguous, sharing no
    storage with a or b, and c's only as c itself (the same view)."""
    if a.dim() != 2:
        raise ValueError("out is taken by 2-D products only")
    want = (a.shape[0], b.shape[-1])
    if out.dtype != a.dtype:
        raise ValueError(f"out must be {a.dtype}, got {out.dtype}")
    if tuple(out.shape) != want:
        raise ValueError(f"out has shape {tuple(out.shape)}; out must have shape {want}")
    if out.device != a.device:
        raise ValueError(f"out must lie on the operands' device {a.device}, got {out.device}")
    if want[1] > 1 and out.stride(-1) != 1:
        raise ValueError(f"the rows of out must be contiguous, got strides {out.stride()}")
    for name, x in (("a", a), ("b", b)):
        if _shares_storage(out, x):
            raise ValueError(f"out shares storage with {name}")
    if c is not None and _shares_storage(out, c) and (
            out.data_ptr() != c.data_ptr() or out.stride() != c.stride()):
        raise ValueError("out shares storage with c without being c itself")


def gemm_int8(
    a: torch.Tensor,
    b: torch.Tensor,
    num_split: int,
    alpha=1.0,
    beta=0.0,
    c: Optional[torch.Tensor] = None,
    n_chunks: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Emulated ``alpha * (a @ b) + beta * c`` on float64 or complex128
    tensors a [m, k], b [k, n] (c [m, n]), or batches [B, m, k] @
    [B, k, n], all of one dtype on one device; the result is of that dtype
    there.  Complex operands run the 4-pass engine on A's and B's planes;
    a 2-D product's fold reads c through its (re, im) views and writes the
    complex128 result itself, interleaved.  ``n_chunks`` as in
    :func:`gemm_f64`.

    ``out`` (2-D products only): a tensor of the product's dtype and shape
    [m, n] on the operands' device, rows contiguous, that takes the result
    in place and is returned; a window of a larger matrix, or c itself
    (each element reads c before it is written), but sharing no storage
    with a or b.  Counted in :data:`IN_PLACE`.  The bits are those of the
    returned tensor."""
    if out is not None:
        _check_out(out, a, b, c)
    batched = a.dim() == 3
    if not a.is_complex():
        got = _entry((a,), (b,), (c,), num_split, float(alpha), float(beta), batched, n_chunks,
                     None if out is None else (out,))[0]
    elif batched:
        C = _planes(c) if c is not None else (None, None)
        re, im = _entry(_planes(a), _planes(b), C, num_split, complex(alpha), complex(beta), True,
                        n_chunks)
        return _complex_result(re, im, False)
    else:
        C = (c.real, c.imag) if c is not None else (None, None)
        dest = out if out is not None else torch.empty(
            (a.shape[0], b.shape[-1]), dtype=torch.complex128, device=a.device)
        got = _entry(_planes(a), _planes(b), C, num_split, complex(alpha), complex(beta), False,
                     n_chunks, dest)
    if out is not None:
        IN_PLACE[str(out.dtype).removeprefix("torch.")] += 1
    return got


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
    return _entry((a,), (b,), (c,), num_split, float(alpha), float(beta), False, n_chunks)[0]


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
    return _entry((a_re, a_im), (b_re, b_im), (c_re, c_im), num_split, complex(alpha),
                  complex(beta), False, n_chunks)


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
    return _entry((a,), (b,), (c,), num_split, float(alpha), float(beta), True)[0]


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
    return _entry((a_re, a_im), (b_re, b_im), (c_re, c_im), num_split, complex(alpha),
                  complex(beta), True)
