"""HPL-class dense solvers on the emulated-FP64 engine.

Port of ``ozimmu_tpu.linalg``.  The reference library's production pitch
is accelerating LU-based FP64 solvers (HPL) by rerouting their GEMMs
through int8 tensor cores — its LD_PRELOAD shim exists so an unmodified
HPL binary's ``cublasDgemm_v2`` calls land in the engine (reference
src/cublas.cu:280-295).  This module provides that workload as a native
capability: a right-looking blocked LU factorization with partial pivoting
whose trailing-matrix updates — asymptotically all of the O(n^3) FLOPs —
run through the engine's full ``alpha*op(A)@op(B) + beta*C`` contract,
a blocked Cholesky factorization, triangular solves, and ``solve`` with
optional HPL-AI-style iterative refinement (factor in a cheap mode such as
``fp64_int8_6`` or ``sgemm``, recover f64-level accuracy with f64 residual
corrections).

Two paths, chosen by ``resident=`` (default: by the container of ``a``):

  * the **host path** (numpy in, numpy out): panels and triangular solves
    in host f64 (LAPACK through scipy), every trailing update one
    :func:`~ozimmu_tpu_torch.core.api.gemm` call on ``device`` in any
    compute mode (AUTO, sgemm and dgemm included);
  * the **resident path** (a ``torch.Tensor`` in, a tensor out): the matrix
    stays one float64 or complex128 tensor on its device; each step's
    triangular solve is a product with the explicit inverse of the unit
    lower block (the standard GPU-HPL formulation), so both it and the
    trailing update are engine GEMMs (``core.gemm.gemm_f64`` /
    ``zgemm_f64``), and on a CUDA tensor every step launches the split and
    the recombine kernel.  ``panel="host"`` pulls each pivot panel to the
    host for LAPACK ``getrf``; ``panel="device"`` factors it where it lies
    with ``torch.linalg.lu_factor_ex``.  Needs a fixed ``fp64_int8_<ns>``
    mode.  With ``mesh=`` it runs row-sharded over a ``DeviceMesh``
    dim, every rank updating its own rows
    (:mod:`ozimmu_tpu_torch.parallel.linalg`).

The JAX package's ``device=`` flag is ``resident=`` here: in this package
``device=`` names the torch device that numpy inputs are placed on.

Numerics: only the GEMM updates use the selected compute mode; the panel
factorizations and triangular solves (O(n^2 * nb) work) run in IEEE f64,
exactly like HPL running over the reference's shim keeps everything but
the cuBLAS GEMM calls in ordinary FP64 code.  With host panels the
resident factorization is exact engine arithmetic around the same LAPACK
calls on every device, so a CUDA run and a CPU run of it agree bit for bit.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .core.api import _planes, gemm
from .core.gemm import gemm_f64, zgemm_f64
from .core.handle import default_handle
from .utils.profiling import synchronize

try:  # LAPACK/BLAS host paths for the O(n^2*nb) non-GEMM work.  The
    # pure-numpy loops below remain as fallbacks; both compute the same
    # factorization (partial pivoting over the full trailing column).
    from scipy.linalg import lu_factor as _sp_lu_factor
    from scipy.linalg import lu_solve as _sp_lu_solve
    from scipy.linalg import solve_triangular as _sp_solve_triangular
except ImportError:  # pragma: no cover - scipy is present in CI
    _sp_lu_factor = _sp_lu_solve = _sp_solve_triangular = None

__all__ = ["lu_factor", "lu_solve", "solve", "cholesky", "cho_solve"]

#: compute mode of the residual ``b - A @ x`` on the resident path: exact
#: to one f64 rounding for any realistic exponent spread
RESIDUAL_MODE = "fp64_int8_12"


# ---------------------------------------------------------------------------
# host helpers (numpy + scipy)
# ---------------------------------------------------------------------------


def _panel_factor_local(panel: np.ndarray, col_offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Partial-pivot LU of a tall panel (``rows x jb``), out of place.

    Returns ``(lu, p_loc)``: the factored panel and LOCAL pivot row
    indices in factorization order (LAPACK getrf ipiv convention: at
    step ``i`` rows ``i`` and ``p_loc[i]`` were swapped).  Uses LAPACK
    ``getrf`` when scipy is available (the panel is O(rows*jb^2) work —
    a Python column loop would dominate the engine GEMMs at benchmark
    sizes), falling back to a numpy loop.  ``col_offset`` only decorates
    the singular-matrix error with the absolute column index.
    """
    jb = panel.shape[1]
    if _sp_lu_factor is not None:
        from scipy.linalg import LinAlgWarning

        try:
            with warnings.catch_warnings():
                # scipy warns (only) on singular factors; leave every
                # other warning alone
                warnings.simplefilter("ignore", category=LinAlgWarning)
                lu, p_loc = _sp_lu_factor(panel, check_finite=False)
        except ValueError:
            # scipy < 1.10 rejects rectangular (tall-panel) input with
            # ValueError('expected square matrix') — the numpy panel loop
            # computes the same factorization
            return _numpy_panel_factor_local(panel, col_offset)
        d = np.diagonal(lu)
        if np.any(d == 0):  # we raise instead (reference getrf info > 0)
            jj = col_offset + int(np.flatnonzero(d == 0)[0])
            raise np.linalg.LinAlgError(f"singular matrix: zero pivot at column {jj}")
        return lu, np.asarray(p_loc[:jb], dtype=np.int64)
    return _numpy_panel_factor_local(panel, col_offset)


def _numpy_panel_factor_local(panel: np.ndarray, col_offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy unblocked panel factorization (fallback when scipy is
    absent or too old for rectangular ``lu_factor``).  A complex column's
    pivot is the entry of largest |re| + |im| (LAPACK ``dcabs1``, what
    ``izamax`` and with it the scipy path use), not of largest modulus."""
    a = panel.copy()
    rows, jb = a.shape
    p_loc = np.zeros(jb, dtype=np.int64)
    for i in range(jb):
        col = a[i:, i]
        mag = np.abs(col.real) + np.abs(col.imag) if np.iscomplexobj(a) else np.abs(col)
        p = i + int(np.argmax(mag))
        if a[p, i] == 0:
            raise np.linalg.LinAlgError(f"singular matrix: zero pivot at column {col_offset + i}")
        p_loc[i] = p
        if p != i:
            a[[i, p], :] = a[[p, i], :]
        if i + 1 < rows:
            a[i + 1:, i] /= a[i, i]
            if i + 1 < jb:
                a[i + 1:, i + 1:] -= np.outer(a[i + 1:, i], a[i, i + 1:])
    return a, p_loc


def _panel_factor(a: np.ndarray, j: int, jb: int, piv: np.ndarray) -> None:
    """Unblocked partial-pivot LU of the panel ``a[j:, j:j+jb]``, in place.

    Pivot rows are swapped across the FULL width of ``a`` (LAPACK getrf
    convention, so already-computed L columns stay consistent) and the
    absolute row indices are recorded in ``piv[j:j+jb]``.
    """
    lu, p_loc = _panel_factor_local(np.ascontiguousarray(a[j:, j:j + jb]), col_offset=j)
    for i in range(jb):  # swap FULL rows of a, in factorization order
        p = j + int(p_loc[i])
        piv[j + i] = p
        if p != j + i:
            a[[j + i, p], :] = a[[p, j + i], :]
    a[j:, j:j + jb] = lu


def _unit_lower_solve(l11: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve ``L11 @ X = B`` with L11 unit lower triangular (real or
    complex), in place on B."""
    if _sp_solve_triangular is not None:
        b[:] = _sp_solve_triangular(l11, b, lower=True, unit_diagonal=True, check_finite=False)
        return b
    for i in range(1, l11.shape[0]):
        b[i, :] -= l11[i, :i] @ b[:i, :]
    return b


def _lower_inverse(l: np.ndarray) -> np.ndarray:
    """Inverse of a (non-unit) lower-triangular matrix, host f64."""
    if _sp_solve_triangular is not None:
        return _sp_solve_triangular(l, np.eye(l.shape[0]), lower=True, check_finite=False)
    x = np.eye(l.shape[0])
    for i in range(l.shape[0]):
        x[i, :] = (x[i, :] - l[i, :i] @ x[:i, :]) / l[i, i]
    return x


# ---------------------------------------------------------------------------
# Resident factorization: the matrix is one tensor on its device between
# panel steps.
#
# Division of labor per outer step (right-looking, LAPACK getrf layout):
#   panel  : factor the (n-j) x jb panel in IEEE f64 (getrf) and invert its
#            unit-lower diagonal block L11 (O(jb^3), backward-stable
#            triangular solves against I) — on the host (scipy) or, with
#            panel="device", where the matrix lies (torch.linalg);
#   device : apply the step's row swaps across the full width, write the
#            factored panel, U12 = L11inv @ A12 and A22 -= L21 @ U12
#            through the int8 engine (exact to one f64 rounding).
#
# The multiply-by-explicit-inverse TRSM is the standard GPU-HPL
# formulation (U12 = L11^-1 A12 evaluated as a GEMM); with partial
# pivoting |L21| <= 1 and the engine product correctly rounded, the extra
# error vs substitution is a small multiple of cond(L11)*eps and sits far
# below the 1e-14 factorization gate.
#
# Real and complex matrices share the code: a complex128 tensor's products
# go through the 4-pass complex engine on its contiguous (re, im) planes.
# Complex pivots are chosen by |re| + |im| (LAPACK izamax / dcabs1) on the
# host and on the device, so both panel kinds pick the same pivot sequence
# on tie-free data.
# ---------------------------------------------------------------------------


def _engine(a: torch.Tensor, b: torch.Tensor, num_split: int, alpha: float = 1.0,
            beta: float = 0.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``alpha * a @ b + beta * c`` through the int8 engine on resident
    float64 or complex128 tensors (windows of the matrix are fine: the
    engine copies its operands contiguous and returns a new tensor, so the
    result may be written back over ``c``)."""
    if a.is_complex():
        c_planes = _planes(c) if c is not None else (None, None)
        re, im = zgemm_f64(*_planes(a), *_planes(b), num_split, complex(alpha), complex(beta),
                           *c_planes)
        return torch.complex(re, im)
    return gemm_f64(a, b, num_split, alpha=alpha, beta=beta, c=c)


def _panel_moves(j: int, n: int, p_loc: np.ndarray, piv: np.ndarray):
    """Record a panel's getrf pivots in ``piv`` and return the rows its
    sequential swaps ``j+i <-> j+p_loc[i]`` move, as ``(dst, src)``: row
    ``dst[t]`` of the n-row matrix takes what row ``src[t]`` held."""
    perm = np.arange(n - j)
    for i, p in enumerate(p_loc):
        p = int(p)
        piv[j + i] = j + p
        if p != i:
            perm[[i, p]] = perm[[p, i]]
    moved = np.flatnonzero(perm != np.arange(n - j))
    return j + moved, j + perm[moved]


def _apply_panel_pivots(A: torch.Tensor, j: int, p_loc: np.ndarray, piv: np.ndarray) -> None:
    """Record a panel's getrf pivots in ``piv`` and apply its row swaps
    across the FULL width of ``A`` (getrf convention: the already-computed
    L history and the trailing columns swap together).  Only the rows that
    move are gathered and written."""
    dst, src = _panel_moves(j, A.shape[0], p_loc, piv)
    if dst.size:
        A[torch.from_numpy(dst).to(A.device)] = A[torch.from_numpy(src).to(A.device)]


@contextlib.contextmanager
def _cusolver_preferred(device: torch.device):
    """On a CUDA device, torch's linear algebra goes to cuSOLVER inside
    the block, and the caller's preference is restored after it.  Left to
    its own choice torch hands a rectangular matrix to MAGMA's batched
    ``getrf``, which is made for small matrices, says so on stderr at
    every call and is several times slower on a tall panel; cuSOLVER's
    ``getrf`` takes rectangular input.

    ``torch.backends.cuda.preferred_linalg_library`` is one setting for
    the whole process, not for a thread or a stream: a ``torch.linalg``
    call that another thread makes while the block is open goes to
    cuSOLVER too.  So the block is opened once around a whole
    factorization with device panels (:func:`_lu_factor_device`), never
    per panel, and a program that factors from several threads should set
    the preference itself, once, before it starts them."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def _panel_factor_device(p: torch.Tensor):
    """Partial-pivot LU of a (rows x jb) panel where it lies:
    ``(lu, p_loc, info)`` with 0-based LOCAL pivots (getrf ipiv) and
    LAPACK's ``info`` (> 0: an exactly zero pivot), both still on the
    panel's device.  The backend is the caller's choice
    (:func:`_cusolver_preferred`)."""
    lu, pivots, info = torch.linalg.lu_factor_ex(p)
    return lu, pivots.to(torch.int64) - 1, info


def _unit_lower_inverse_device(l: torch.Tensor) -> torch.Tensor:
    """inv(L) for unit-lower L (only the strict lower triangle is read)."""
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False, unitriangular=True)


def _lu_step_device(A: torch.Tensor, j: int, jb: int, num_split: int, lu_panel: torch.Tensor,
                    l11inv: Optional[torch.Tensor]) -> None:
    """The device half of one right-looking LU step, in place on ``A``
    (rows already swapped): panel writeback, engine TRSM, trailing update."""
    n = A.shape[0]
    rest = j + jb
    A[j:, j:rest] = lu_panel
    if rest < n:
        # U12 = L11^-1 @ A12 as an engine GEMM (explicit-inverse TRSM)
        u12 = _engine(l11inv, A[j:rest, rest:], num_split)
        A[j:rest, rest:] = u12
        # A22 -= L21 @ U12 (asymptotically all the FLOPs)
        A[rest:, rest:] = _engine(A[rest:, j:rest], u12, num_split, -1.0, 1.0, A[rest:, rest:])


class _Clock:
    """Per-phase seconds into ``profile`` (a dict that accumulates them;
    None: no timing and no waits for the device)."""

    def __init__(self, profile, device: torch.device):
        self.profile, self.device, self.t = profile, device, 0.0

    def start(self) -> None:
        if self.profile is not None:
            synchronize(self.device)
            self.t = time.perf_counter()

    def lap(self, key: str, wait: bool = False) -> None:
        """Add the seconds since the last start or lap to ``key``, after
        waiting for the device if ``wait``."""
        if self.profile is not None:
            if wait:
                synchronize(self.device)
            now = time.perf_counter()
            self.profile[key] = self.profile.get(key, 0.0) + (now - self.t)
            self.t = now


def _factor_panel(pnl: torch.Tensor, j: int, inverse: bool, panel: str, clock: _Clock):
    """Partial-pivot LU of the (rows x jb) panel ``pnl`` whose first column
    is column ``j`` of the matrix; ``pnl`` is left untouched.  Returns
    ``(lu_p, p_loc, l11inv)``: the factored panel on ``pnl``'s device, the
    0-based LOCAL getrf pivots as a numpy array, and, if ``inverse``, the
    inverse of the unit-lower diagonal block L11 there (else None).
    ``panel="host"`` pulls the panel to the host for LAPACK ``getrf``
    (phases ``panel_pull_s``, ``panel_host_s``); ``"device"`` factors it
    where it lies (``panel_device_s``).  Raises ``LinAlgError`` on an
    exactly zero pivot."""
    dev = pnl.device
    jb = pnl.shape[1]
    if panel == "host":
        host = np.ascontiguousarray(pnl.cpu().numpy())
        clock.lap("panel_pull_s")
        lu_p, p_loc = _panel_factor_local(host, col_offset=j)
        l11inv = None
        if inverse:
            l11inv = torch.from_numpy(
                _unit_lower_solve(lu_p[:jb, :jb], np.eye(jb, dtype=lu_p.dtype))).to(dev)
        lu_p = torch.from_numpy(lu_p).to(dev)
        clock.lap("panel_host_s")
        return lu_p, p_loc, l11inv
    lu_p, p_dev, info = _panel_factor_device(pnl)
    # one read per step: the jb pivots and getrf's info
    head = torch.cat([p_dev, info.reshape(1).to(torch.int64)]).cpu().numpy()
    if head[-1] != 0:
        raise np.linalg.LinAlgError("singular matrix: zero pivot")
    l11inv = _unit_lower_inverse_device(lu_p[:jb]) if inverse else None
    clock.lap("panel_device_s", wait=True)
    return lu_p, head[:jb], l11inv


def _lu_factor_device(a: torch.Tensor, num_split: int, block: int, profile=None,
                      panel: str = "host") -> Tuple[torch.Tensor, np.ndarray]:
    """Resident blocked LU of a float64 or complex128 tensor on its own
    device; the caller's tensor is left untouched.  ``profile`` (optional
    dict) accumulates per-phase seconds — ``panel_pull_s``,
    ``panel_host_s`` and ``device_update_s`` with host panels,
    ``panel_device_s`` and ``device_update_s`` with device panels.
    Profiling waits for the device at the phase edges, so leave it None
    for wall timing."""
    _check_panel(panel)
    with _panel_backend(a.device, panel):
        return _lu_factor_steps(a, num_split, block, profile, panel)


def _check_panel(panel: str) -> None:
    if panel not in ("host", "device"):
        raise ValueError(f"panel must be 'host' or 'device', got {panel!r}")


def _panel_backend(device: torch.device, panel: str):
    """The context of a whole factorization with ``panel`` panels."""
    return _cusolver_preferred(device) if panel == "device" else contextlib.nullcontext()


def _lu_factor_steps(a: torch.Tensor, num_split: int, block: int, profile, panel: str):
    """The steps of :func:`_lu_factor_device`."""
    n = a.shape[0]
    nb = max(1, min(int(block), n))
    A = a.clone(memory_format=torch.contiguous_format)
    clock = _Clock(profile, A.device)
    piv = np.arange(n)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        clock.start()
        lu_p, p_loc, l11inv = _factor_panel(A[j:, j:j + jb], j, j + jb < n, panel, clock)
        _apply_panel_pivots(A, j, p_loc, piv)
        _lu_step_device(A, j, jb, num_split, lu_p, l11inv)
        clock.lap("device_update_s", wait=True)
    return A, piv


def _cholesky_diagonal(d: np.ndarray, j: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(L11, inv(L11)^T)`` of the diagonal block ``d`` at column ``j``,
    in host f64; raises ``LinAlgError`` if it is not positive definite."""
    try:
        l11 = np.linalg.cholesky(d)
    except np.linalg.LinAlgError as e:
        raise np.linalg.LinAlgError(
            f"matrix is not positive definite (diagonal block at {j})"
        ) from e
    return l11, np.ascontiguousarray(_lower_inverse(l11).T)


def _cholesky_device(a: torch.Tensor, num_split: int, block: int, profile=None) -> torch.Tensor:
    """Resident blocked Cholesky of a real SPD float64 tensor.  Unlike LU,
    only the jb x jb diagonal block crosses to the host per step (no
    pivoting), so host traffic is O(n * nb) in all.  The panel solve is the
    engine GEMM ``L21 = A21 @ L11^-T`` against the host-computed inverse,
    the trailing update ``A22 -= L21 @ L21^T``."""
    n = a.shape[0]
    nb = max(1, min(int(block), n))
    A = a.clone(memory_format=torch.contiguous_format)
    dev = A.device
    clock = _Clock(profile, dev)
    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        clock.start()
        l11, inv_t = _cholesky_diagonal(np.ascontiguousarray(A[j:rest, j:rest].cpu().numpy()), j)
        clock.lap("panel_host_s")
        A[j:rest, j:rest] = torch.from_numpy(l11).to(dev)
        if rest < n:
            l21 = gemm_f64(A[rest:, j:rest], torch.from_numpy(inv_t).to(dev), num_split)
            A[rest:, j:rest] = l21
            A[rest:, rest:] = gemm_f64(l21, l21.T, num_split, alpha=-1.0, beta=1.0,
                                       c=A[rest:, rest:])
        clock.lap("device_update_s", wait=True)
    return torch.tril(A)


def _resolve_int8_num_split(mode, handle) -> int:
    """Resolve ``mode`` to a fixed int8 split count for the resident paths
    (which call the engine cores directly)."""
    h = handle or default_handle()
    mode_r = h.resolve_mode(mode)
    if not mode_r.is_int8:
        raise ValueError(
            "resident factorization needs a fixed fp64_int8_<ns> "
            f"mode (got {mode_r.value}); use resident=False for "
            "auto/sgemm/dgemm"
        )
    return mode_r.num_split


def _resident_operand(a, name: str, resident: Optional[bool], mesh, handle, device):
    """Shared front door of :func:`lu_factor` and :func:`cholesky`:
    ``(resident, a)`` where ``a`` is, on the resident path, a square
    float64 or complex128 tensor: a numpy ``a`` placed on ``device``
    (default the handle's), or left in host memory with a ``mesh``, whose
    ranks each take their rows to the mesh's device."""
    is_tensor = isinstance(a, torch.Tensor)
    if resident is None:
        resident = is_tensor or mesh is not None
    if not resident:
        if mesh is not None:
            raise ValueError(f"{name}: a mesh requires the resident path (resident=True)")
        if is_tensor:
            raise ValueError(
                f"{name}: a tensor is factored where it lies (resident=True); pass a numpy "
                "array for the host path"
            )
        return False, a
    if is_tensor:
        if a.dtype not in (torch.float64, torch.complex128):
            raise TypeError(f"{name}: expected float64 or complex128, got {a.dtype}")
        shape = tuple(a.shape)
    else:
        a = np.asarray(a)
        shape = a.shape
    if len(shape) != 2 or shape[0] != shape[1]:
        raise ValueError(f"{name} needs a square 2D matrix, got {shape}")
    if not is_tensor:
        dt = np.complex128 if np.iscomplexobj(a) else np.float64
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
        if mesh is None:
            a = a.to(torch.device(device if device is not None else
                                  (handle or default_handle()).device))
    return True, a


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    if x.is_complex():
        # the JAX package's construction (signed zeros follow numpy's
        # complex arithmetic), so the numpy results match it bit for bit
        return x.real.cpu().numpy() + 1j * x.imag.cpu().numpy()
    return x.cpu().numpy()


def lu_factor(
    a,
    *,
    mode=None,
    block: int = 256,
    handle=None,
    resident: Optional[bool] = None,
    panel: str = "host",
    profile=None,
    mesh=None,
    mesh_axis: str = "x",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Blocked LU factorization with partial pivoting: ``P @ A = L @ U``.

    Right-looking algorithm: each iteration factors a ``block``-column
    panel in IEEE f64, then applies the trailing-matrix update
    ``A22 -= L21 @ U12`` through the engine with ``alpha=-1, beta=1,
    c=A22`` in the selected compute mode — the same division of labor HPL
    has when running over the reference shim (panel/TRSM in FP64, GEMM on
    the emulation engine).

    Returns ``(lu, piv)`` in the LAPACK ``getrf`` convention: ``lu``
    holds L (unit diagonal, below) and U (on/above the diagonal);
    ``piv[i]`` (a numpy array) is the row swapped with row ``i`` at step
    ``i``.  Real f64 or complex128 input.

    ``resident`` selects the resident variant (see the module docstring).
    The default (None) uses it iff ``a`` is a ``torch.Tensor``: tensor in
    -> (tensor on the same device, piv) out; numpy in -> (numpy, piv) out,
    with ``device`` (default: the handle's, ``"cuda"``) the device that a
    numpy matrix and the host path's GEMM operands are placed on.  The
    host path takes every mode :func:`ozimmu_tpu_torch.gemm` does,
    ``"fp64_int8_auto"`` and cheap modes for refinement-based solvers
    included; the resident path needs a fixed int8 mode.
    ``panel="device"`` (resident only) also factors the pivot panels on
    the matrix's device, so nothing but the jb pivot indices of each step
    reaches the host; ``"host"`` (default) keeps LAPACK panels.
    ``profile`` (dict) collects per-phase seconds on the resident path.

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``) row-shards
    the resident factorization over its dim ``mesh_axis``
    (:mod:`ozimmu_tpu_torch.parallel.linalg`): every rank of the mesh
    calls this with the same matrix and gets the same result; each holds
    a block of rows on the mesh's device and runs the trailing updates of
    its rows.  With host panels the factor is bitwise the one-device one;
    with device panels one rank factors each panel as the one-device run
    does, so the pivots are the same (and so are the bits wherever the
    panel library is deterministic, as on the CPU and an H100).  Implies
    ``resident=True``; ``device`` is then the mesh's.
    """
    is_tensor = isinstance(a, torch.Tensor)
    resident, a = _resident_operand(a, "lu_factor", resident, mesh, handle, device)
    if resident:
        num_split = _resolve_int8_num_split(mode, handle)
        if mesh is not None:
            from .parallel.linalg import lu_factor_sharded

            lu, piv = lu_factor_sharded(a, num_split, block, mesh, mesh_axis, panel, profile)
        else:
            lu, piv = _lu_factor_device(a, num_split, block, profile, panel)
        return (lu, piv) if is_tensor else (_to_numpy(lu), piv)

    a = np.array(a, order="C", copy=True)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"lu_factor needs a square 2D matrix, got {a.shape}")
    if not np.iscomplexobj(a):
        a = a.astype(np.float64, copy=False)
    n = a.shape[0]
    nb = max(1, min(int(block), n))
    piv = np.arange(n)

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        _panel_factor(a, j, jb, piv)
        rest = j + jb
        if rest >= n:
            break
        # U12 = L11^{-1} @ A12  (unit lower triangular solve, host f64)
        _unit_lower_solve(a[j:rest, j:rest], a[j:rest, rest:])
        # trailing update through the engine: A22 -= L21 @ U12
        a[rest:, rest:] = gemm(
            np.ascontiguousarray(a[rest:, j:rest]),
            np.ascontiguousarray(a[j:rest, rest:]),
            mode=mode,
            alpha=-1.0,
            beta=1.0,
            c=np.ascontiguousarray(a[rest:, rest:]),
            handle=handle,
            device=device,
        )
    return a, piv


def cholesky(
    a,
    *,
    mode=None,
    block: int = 256,
    handle=None,
    resident: Optional[bool] = None,
    profile=None,
    mesh=None,
    mesh_axis: str = "x",
    device=None,
) -> np.ndarray:
    """Blocked Cholesky factorization ``A = L @ L^H`` (lower), SPD/HPD input.

    Right-looking algorithm, same division of labor as :func:`lu_factor`:
    the diagonal block factors in host f64 (O(n * nb^2) work), the panel
    solve ``L21 = A21 @ L11^-H`` is a host triangular solve, and the
    trailing Hermitian update ``A22 -= L21 @ L21^H`` — asymptotically all
    the O(n^3/3) FLOPs — runs through :func:`ozimmu_tpu_torch.gemm` with
    ``alpha=-1, beta=1, c=A22`` in the selected compute mode.

    Only the lower triangle of ``a`` is read.  Returns L with the strict
    upper triangle zeroed.  Raises ``LinAlgError`` if a diagonal block is
    not positive definite.

    ``resident`` selects the resident variant (default: iff ``a`` is a
    ``torch.Tensor``; tensor in -> tensor out): real SPD only, a fixed
    int8 mode, only the jb x jb diagonal block crosses to the host per
    step, and the panel solve is an engine GEMM too.  ``device`` places
    numpy inputs as in :func:`lu_factor`; ``mesh`` / ``mesh_axis``
    row-shard the resident factorization as there (bitwise the one-device
    factor).
    """
    is_tensor = isinstance(a, torch.Tensor)
    resident, a = _resident_operand(a, "cholesky", resident, mesh, handle, device)
    if resident:
        num_split = _resolve_int8_num_split(mode, handle)
        if a.is_complex():
            raise ValueError(
                "resident cholesky is real-only; complex HPD "
                "input runs the host path (resident=False)"
            )
        if mesh is not None:
            from .parallel.linalg import cholesky_sharded

            l = cholesky_sharded(a, num_split, block, mesh, mesh_axis, profile)
        else:
            l = _cholesky_device(a, num_split, block, profile)
        return l if is_tensor else _to_numpy(l)

    a = np.array(a, order="C", copy=True)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"cholesky needs a square 2D matrix, got {a.shape}")
    if not np.iscomplexobj(a):
        a = a.astype(np.float64, copy=False)
    n = a.shape[0]
    nb = max(1, min(int(block), n))

    for j in range(0, n, nb):
        jb = min(nb, n - j)
        rest = j + jb
        # host f64: factor the diagonal block (reads its lower triangle)
        try:
            l11 = np.linalg.cholesky(a[j:rest, j:rest])
        except np.linalg.LinAlgError as e:
            raise np.linalg.LinAlgError(
                f"matrix is not positive definite (diagonal block at {j})"
            ) from e
        a[j:rest, j:rest] = l11
        if rest >= n:
            break
        # host f64: panel solve L21 = A21 @ L11^-H  (triangular, O(n*nb^2))
        l21 = a[rest:, j:rest]
        if _sp_solve_triangular is not None:
            # L21 @ L11^H = A21  <=>  L11 @ (L21^H) = A21^H  (BLAS trsm)
            l21[:] = np.conj(
                _sp_solve_triangular(l11, np.conj(l21).T, lower=True, check_finite=False)
            ).T
        else:
            for i in range(jb):  # forward substitution on columns of L21
                l21[:, i] = (l21[:, i] - l21[:, :i] @ np.conj(l11[i, :i])) / np.conj(l11[i, i])
        # engine: trailing Hermitian update A22 -= L21 @ L21^H
        # (Operation.C is exact here; the reference shim would silently
        # compute L21 @ L21^T instead, src/cublas.cu:50-56)
        a[rest:, rest:] = gemm(
            np.ascontiguousarray(l21),
            np.ascontiguousarray(l21),
            op_b="C",
            mode=mode,
            alpha=-1.0,
            beta=1.0,
            c=np.ascontiguousarray(a[rest:, rest:]),
            handle=handle,
            device=device,
        )
    return np.tril(a)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def _rhs(b, n: int, complex_: bool, device=None):
    """``(is_np, vec, x)``: the right-hand side as a fresh 2-D float64 or
    complex128 array (numpy, or a tensor on ``device`` when one is given)
    with ``n`` rows; complex if it or the factor is."""
    is_np = not isinstance(b, torch.Tensor)
    if device is None:
        x = np.array(b, copy=True)
        cx = complex_ or np.iscomplexobj(x)
        x = x.astype(np.complex128 if cx else np.float64, copy=False)
    else:
        x = torch.from_numpy(np.asarray(b)) if is_np else b
        cx = complex_ or x.is_complex()
        x = x.to(device=device, dtype=torch.complex128 if cx else torch.float64, copy=True)
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    if x.shape[0] != n:
        raise ValueError(f"rhs rows {x.shape[0]} != matrix size {n}")
    return is_np, vec, x


def _like_rhs(x: torch.Tensor, is_np: bool, vec: bool):
    x = x[:, 0] if vec else x
    return x.cpu().numpy() if is_np else x


def lu_solve(lu_and_piv: Tuple[np.ndarray, np.ndarray], b):
    """Solve ``A @ x = b`` from :func:`lu_factor` output (O(n^2)
    forward/back substitution in IEEE f64).  A numpy factor is solved on
    the host (LAPACK getrs); a tensor factor where it lies
    (``torch.linalg.lu_solve``).  Returns the container kind of ``b``."""
    lu, piv = lu_and_piv
    n = lu.shape[0]
    if isinstance(lu, torch.Tensor):
        is_np, vec, x = _rhs(b, n, lu.is_complex(), lu.device)
        pivots = torch.from_numpy(np.asarray(piv) + 1).to(device=lu.device, dtype=torch.int32)
        return _like_rhs(torch.linalg.lu_solve(lu.to(x.dtype), pivots, x), is_np, vec)
    _, vec, x = _rhs(b, n, np.iscomplexobj(lu))
    if _sp_lu_solve is not None:  # LAPACK getrs (same piv convention)
        out = _sp_lu_solve((lu, np.asarray(piv)), x, check_finite=False)
        return out[:, 0] if vec else out
    for i in range(n):  # apply pivots in factorization order
        p = piv[i]
        if p != i:
            x[[i, p], :] = x[[p, i], :]
    for i in range(1, n):  # L y = P b (unit diagonal)
        x[i, :] -= lu[i, :i] @ x[:i, :]
    for i in range(n - 1, -1, -1):  # U x = y
        if i + 1 < n:
            x[i, :] -= lu[i, i + 1:] @ x[i + 1:, :]
        x[i, :] /= lu[i, i]
    return x[:, 0] if vec else x


def cho_solve(l, b):
    """Solve ``A @ x = b`` from :func:`cholesky` output (O(n^2)
    forward/back substitution with ``L`` and ``L^H``): a numpy factor on
    the host, a tensor factor where it lies.  Returns the container kind
    of ``b``."""
    if isinstance(l, torch.Tensor):
        is_np, vec, x = _rhs(b, l.shape[0], l.is_complex(), l.device)
        l = l.to(x.dtype)
        y = torch.linalg.solve_triangular(l, x, upper=False)
        return _like_rhs(torch.linalg.solve_triangular(l.mH, y, upper=True), is_np, vec)
    l = np.asarray(l)
    n = l.shape[0]
    _, vec, x = _rhs(b, n, np.iscomplexobj(l))
    if _sp_solve_triangular is not None:  # two BLAS trsm calls
        y = _sp_solve_triangular(l, x, lower=True, check_finite=False)
        out = _sp_solve_triangular(l, y, lower=True, trans="C", check_finite=False)
        return out[:, 0] if vec else out
    for i in range(n):  # L y = b
        if i:
            x[i, :] -= l[i, :i] @ x[:i, :]
        x[i, :] /= l[i, i]
    lh = np.conj(l)
    for i in range(n - 1, -1, -1):  # L^H x = y
        if i + 1 < n:
            x[i, :] -= lh[i + 1:, i] @ x[i + 1:, :]
        x[i, :] /= lh[i, i]
    return x[:, 0] if vec else x


def engine_matvec(a: torch.Tensor, v, alpha=1.0, beta=0.0, c=None, handle=None):
    """``alpha * a @ v + beta * c`` for a resident matrix ``a`` through the
    engine at :data:`RESIDUAL_MODE` (one f64 rounding per element); ``v``
    and ``c`` are vectors or thin matrices, numpy or tensors, and the
    result has the container kind and shape of ``v``.  One engine call: the
    split of ``a`` is the working set, 12 bytes an element beside the 8 of
    the matrix itself.
    """
    n, k = a.shape
    is_np, vec, vt = _rhs(v, k, a.is_complex(), a.device)
    ct = _rhs(c, n, a.is_complex(), a.device)[2] if c is not None else None
    out = gemm(a, vt, mode=RESIDUAL_MODE, alpha=alpha, beta=beta, c=ct, handle=handle)
    return _like_rhs(out, is_np, vec)


def solve(
    a,
    b,
    *,
    mode=None,
    block: int = 256,
    refine: int = 0,
    handle=None,
    factor: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device=None,
):
    """Solve ``A @ x = b`` via blocked LU on the engine.

    ``refine > 0`` adds that many steps of iterative refinement with f64
    residuals (``r = b - A @ x`` is an O(n^2) matvec): the HPL-AI recipe —
    factor cheaply (e.g. ``mode="fp64_int8_6"`` or ``"sgemm"``), then each
    correction solve against the same cheap factors multiplies the
    accuracy until it converges at the f64 working precision.  With
    ``mode="fp64_int8_9"`` the factorization is already at the f64
    rounding floor and ``refine=0`` suffices.

    Pass ``factor=(lu, piv)`` (from :func:`lu_factor`) to reuse an
    existing factorization across solves, a row-sharded one
    (``lu_factor(a, mesh=...)``) included.

    With a tensor ``a`` (float64 or complex128) the factorization runs
    resident and the refinement residual is computed through the engine at
    ``fp64_int8_12`` (exact to one f64 rounding for any realistic exponent
    spread) instead of a host matvec — ``a`` never leaves its device.
    Returns the container kind of ``b``.
    """
    fac = factor if factor is not None else lu_factor(
        a, mode=mode, block=block, handle=handle, device=device
    )
    x = lu_solve(fac, b)
    if isinstance(a, torch.Tensor):
        for _ in range(int(refine)):
            x = x + lu_solve(fac, engine_matvec(a, x, alpha=-1.0, beta=1.0, c=b, handle=handle))
        return x
    a = np.asarray(a)
    for _ in range(int(refine)):
        r = np.asarray(b) - a @ x
        x = x + lu_solve(fac, r)
    return x
