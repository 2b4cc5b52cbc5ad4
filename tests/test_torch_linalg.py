"""The solvers (``ozimmu_tpu_torch.linalg``) on the CPU against
``ozimmu_tpu.linalg``: the same numpy inputs from a seed go through both.

Tolerances, per test: **bitwise** (factor bits and pivots) wherever both
packages run exact engine arithmetic around the same LAPACK calls — the
host path, the resident path with host panels (tensor in here, ``F64X`` or
plane tuples in there) and Cholesky; equal pivots and 1e-12 relative for
``panel="device"`` (this package factors the panel with LAPACK through
torch, the JAX package with its own recursive loop); the JAX tests'
residual gates (1e-14 factorization, 1e-15 scaled solve residual)
elsewhere.  Complex parity inputs stay at ns >= 8 and a narrow exponent
spread (XLA:CPU flushes f32 subnormals, ROADMAP.md queue 3).  Shapes are
small and shared between tests, because every JAX step program compiles
once per shape."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu import linalg as jl  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu_torch import linalg as tl  # noqa: E402
from ozimmu_tpu_torch.core.bits import (  # noqa: E402
    from_f64x_planes, from_zf64x_planes, to_f64x_planes, to_zf64x_planes,
)

CPU = dict(device="cpu")


def _u64(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag]).view(np.uint64)
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _tensor_u64(x):
    return _u64(x.numpy())


def _matrix(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, size=(n, n))
    if complex_:
        a = a + 1j * rng.uniform(-1, 1, size=(n, n))
    return a


def _spd(n, seed, complex_=False):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n))
    if complex_:
        g = g + 1j * rng.normal(size=(n, n))
    return g @ np.conj(g.T) + n * np.eye(n)


def _pa_lu_residual(a, lu, piv):
    """||P A - L U||_F / ||A||_F with P reconstructed from getrf pivots."""
    n = a.shape[0]
    pa = a.copy()
    for i in range(n):
        p = piv[i]
        if p != i:
            pa[[i, p], :] = pa[[p, i], :]
    l = np.tril(lu, -1) + np.eye(n, dtype=lu.dtype)
    return np.linalg.norm(pa - l @ np.triu(lu)) / np.linalg.norm(a)


def _solve_residual(a, x, b):
    return np.linalg.norm(a @ x - b) / (
        np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b))


#: (n, block, ns, complex): fp64_int8_9 and one other ns, a block that
#: divides n and one that does not, real and complex
LU_CASES = [(96, 32, 9, False), (70, 48, 6, False), (96, 32, 9, True), (70, 48, 12, True)]


# ---------------------------------------------------------------------------
# bitwise parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block,ns,complex_", LU_CASES)
def test_host_path_lu_bits_equal_the_jax_packages(n, block, ns, complex_):
    a = _matrix(n, seed=n + ns, complex_=complex_)
    mode = f"fp64_int8_{ns}"
    lu, piv = tl.lu_factor(a, mode=mode, block=block, **CPU)
    jlu, jpiv = jl.lu_factor(a, mode=mode, block=block)
    assert isinstance(lu, np.ndarray) and lu.dtype == jlu.dtype
    np.testing.assert_array_equal(piv, jpiv)
    np.testing.assert_array_equal(_u64(lu), _u64(jlu))
    assert _pa_lu_residual(a, lu, piv) < (1e-14 if ns >= 9 else 1e-9)


@pytest.mark.parametrize("mode", ["fp64_int8_auto", "sgemm", "dgemm"])
def test_host_path_takes_every_gemm_mode(mode):
    a = _matrix(96, seed=3) + 4 * np.eye(96)
    lu, piv = tl.lu_factor(a, mode=mode, block=32, **CPU)
    assert _pa_lu_residual(a, lu, piv) < (1e-6 if mode == "sgemm" else 1e-14)
    if mode == "dgemm":  # torch's f64 matmul on both sides of the same LAPACK calls
        jlu, jpiv = jl.lu_factor(a, mode=mode, block=32)
        np.testing.assert_array_equal(piv, jpiv)
        np.testing.assert_allclose(lu, jlu, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,block,ns", [(96, 32, 9), (70, 48, 6)])
def test_resident_lu_host_panels_bits_equal_the_jax_packages(n, block, ns):
    a = _matrix(n, seed=30 + n)
    at = torch.from_numpy(a.copy())
    lu, piv = tl.lu_factor(at, mode=f"fp64_int8_{ns}", block=block)
    assert isinstance(lu, torch.Tensor) and lu.dtype == torch.float64
    np.testing.assert_array_equal(at.numpy(), a)  # the caller's tensor survives
    hi, lo = to_f64x_planes(at)
    jluX, jpiv = jl.lu_factor(F64X(jnp.asarray(hi), jnp.asarray(lo)), mode=f"fp64_int8_{ns}",
                              block=block)
    want = from_f64x_planes(np.asarray(jluX.hi), np.asarray(jluX.lo)).reshape(n, n)
    np.testing.assert_array_equal(piv, jpiv)
    np.testing.assert_array_equal(_tensor_u64(lu), _tensor_u64(want))
    assert _pa_lu_residual(a, lu.numpy(), piv) < (1e-14 if ns >= 9 else 1e-9)
    # numpy in with resident=True: the same factor, back as numpy
    lu_np, piv_np = tl.lu_factor(a, mode=f"fp64_int8_{ns}", block=block, resident=True, **CPU)
    np.testing.assert_array_equal(piv_np, piv)
    np.testing.assert_array_equal(_u64(lu_np), _tensor_u64(lu))


@pytest.mark.parametrize("n,block,ns", [(64, 32, 9), (70, 48, 8)])
def test_resident_complex_lu_host_panels_bits_equal_the_jax_packages(n, block, ns):
    a = _matrix(n, seed=41 + n, complex_=True)
    at = torch.from_numpy(a.copy())
    lu, piv = tl.lu_factor(at, mode=f"fp64_int8_{ns}", block=block)
    assert isinstance(lu, torch.Tensor) and lu.dtype == torch.complex128
    planes_in = tuple(jnp.asarray(p) for p in to_zf64x_planes(at))
    planes, jpiv = jl._zlu_factor_device(planes_in, ns, block, return_planes=True)
    want = from_zf64x_planes(*(np.asarray(p) for p in planes)).reshape(n, n)
    np.testing.assert_array_equal(piv, jpiv)
    np.testing.assert_array_equal(_tensor_u64(lu), _tensor_u64(want))
    assert _pa_lu_residual(a, lu.numpy(), piv) < 1e-14
    # numpy in with resident=True equals the JAX package's numpy result
    lu_np, _ = tl.lu_factor(a, mode=f"fp64_int8_{ns}", block=block, resident=True, **CPU)
    jlu_np, _ = jl.lu_factor(a, mode=f"fp64_int8_{ns}", block=block, device=True)
    np.testing.assert_array_equal(_u64(lu_np), _u64(jlu_np))


@pytest.mark.parametrize("complex_", [False, True])
def test_host_path_cholesky_bits_equal_the_jax_packages(complex_):
    a = _spd(70, seed=10, complex_=complex_)
    l = tl.cholesky(a, mode="fp64_int8_9", block=48, **CPU)
    np.testing.assert_array_equal(_u64(l), _u64(jl.cholesky(a, mode="fp64_int8_9", block=48)))
    assert np.allclose(np.triu(l, 1), 0)
    assert np.linalg.norm(a - l @ np.conj(l.T)) / np.linalg.norm(a) < 1e-14


@pytest.mark.parametrize("n,block", [(96, 32), (70, 48)])
def test_resident_cholesky_bits_equal_the_jax_packages(n, block):
    a = _spd(n, seed=33)
    at = torch.from_numpy(a.copy())
    l = tl.cholesky(at, mode="fp64_int8_9", block=block)
    assert isinstance(l, torch.Tensor)
    np.testing.assert_array_equal(at.numpy(), a)
    hi, lo = to_f64x_planes(at)
    jlX = jl.cholesky(F64X(jnp.asarray(hi), jnp.asarray(lo)), mode="fp64_int8_9", block=block)
    want = from_f64x_planes(np.asarray(jlX.hi), np.asarray(jlX.lo)).reshape(n, n)
    np.testing.assert_array_equal(_tensor_u64(l), _tensor_u64(want))
    ln = l.numpy()
    assert np.all(np.triu(ln, 1) == 0)
    assert np.linalg.norm(a - ln @ ln.T) / np.linalg.norm(a) < 1e-14
    l_np = tl.cholesky(a, mode="fp64_int8_9", block=block, resident=True, **CPU)
    np.testing.assert_array_equal(_u64(l_np), _u64(ln))


@pytest.mark.parametrize("n,block,complex_", [(96, 32, False), (70, 48, False), (64, 32, True)])
def test_device_panels_same_pivots_as_the_jax_packages(n, block, complex_):
    """Both packages factor the panel in IEEE f64 on the CPU but by
    different algorithms: pivots equal on tie-free data, values to 1e-12
    relative, the factorization under the 1e-14 gate."""
    a = _matrix(n, seed=50 + n, complex_=complex_)
    lu, piv = tl.lu_factor(torch.from_numpy(a), mode="fp64_int8_9", block=block, panel="device")
    jlu, jpiv = jl.lu_factor(a, mode="fp64_int8_9", block=block, device=True, panel="device")
    np.testing.assert_array_equal(piv, jpiv)
    assert np.abs(lu.numpy() - jlu).max() / np.abs(jlu).max() < 1e-12
    assert _pa_lu_residual(a, lu.numpy(), piv) < 1e-14
    # and as the host panels of this package choose them
    _, piv_h = tl.lu_factor(torch.from_numpy(a), mode="fp64_int8_9", block=block, panel="host")
    np.testing.assert_array_equal(piv, piv_h)


def test_numpy_path_solve_bits_equal_the_jax_packages():
    a = _matrix(96, seed=5) + 4 * np.eye(96)
    rng = np.random.default_rng(6)
    for b in (a @ rng.normal(size=96), rng.normal(size=(96, 3))):
        x = tl.solve(a, b, mode="fp64_int8_9", block=32, refine=1, **CPU)
        np.testing.assert_array_equal(
            _u64(x), _u64(jl.solve(a, b, mode="fp64_int8_9", block=32, refine=1)))
        assert x.shape == b.shape and _solve_residual(a, x, b) < 1e-15


# ---------------------------------------------------------------------------
# solve, refinement and the triangular solves on resident factors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_", [False, True])
def test_resident_solve_with_refinement_from_a_cheap_factor(complex_):
    """The HPL-AI recipe on a tensor: factor at fp64_int8_6, two residual
    corrections through the engine at fp64_int8_12 reach the 1e-15 gate
    (tests/test_linalg.py::test_solve_f64x_with_refinement)."""
    rng = np.random.default_rng(32)
    n = 96
    a = _matrix(n, seed=32, complex_=complex_) + n * np.eye(n)
    at = torch.from_numpy(a)
    b = a @ rng.standard_normal(n)
    x0 = tl.solve(at, b, mode="fp64_int8_6", block=32)
    x = tl.solve(at, b, mode="fp64_int8_6", block=32, refine=2)
    assert isinstance(x, np.ndarray) and x.shape == b.shape
    assert _solve_residual(a, x0, b) > _solve_residual(a, x, b)
    assert _solve_residual(a, x, b) < 1e-15
    # matrix right-hand side, a tensor: a tensor comes back
    bm = torch.from_numpy(rng.standard_normal((n, 3)) + (0j if complex_ else 0.0))
    xm = tl.solve(at, bm, mode="fp64_int8_6", block=32, refine=2)
    assert isinstance(xm, torch.Tensor) and xm.shape == bm.shape
    assert _solve_residual(a, xm.numpy(), bm.numpy()) < 1e-15
    # factor= reuse, with device panels
    fac = tl.lu_factor(at, mode="fp64_int8_6", block=32, panel="device")
    xf = tl.solve(at, b, refine=2, factor=fac)
    assert _solve_residual(a, xf, b) < 1e-15


def test_lu_solve_and_cho_solve_agree_between_host_and_resident_factors():
    rng = np.random.default_rng(14)
    a = _matrix(70, seed=14) + 8 * np.eye(70)
    b = rng.normal(size=(70, 2))
    fac = tl.lu_factor(a, mode="fp64_int8_9", block=48, resident=True, **CPU)
    fac_t = tl.lu_factor(torch.from_numpy(a), mode="fp64_int8_9", block=48)
    np.testing.assert_allclose(tl.lu_solve(fac_t, b), tl.lu_solve(fac, b), rtol=1e-11)
    np.testing.assert_array_equal(_u64(tl.lu_solve(fac, b)), _u64(jl.lu_solve(fac, b)))
    bz = b[:, 0] + 1j * b[:, 1]  # a complex right-hand side on a real factor
    np.testing.assert_allclose(tl.lu_solve(fac_t, bz), tl.lu_solve(fac, bz), rtol=1e-11)
    with pytest.raises(ValueError, match="rhs rows"):
        tl.lu_solve(fac, np.ones(71))
    with pytest.raises(ValueError, match="rhs rows"):
        tl.lu_solve(fac_t, np.ones(71))

    s = _spd(70, seed=15)
    l = tl.cholesky(s, mode="fp64_int8_9", block=48, **CPU)
    x = tl.cho_solve(l, s @ b[:, 0])
    np.testing.assert_array_equal(_u64(x), _u64(jl.cho_solve(l, s @ b[:, 0])))
    assert _solve_residual(s, x, s @ b[:, 0]) < 1e-15
    xt = tl.cho_solve(torch.from_numpy(l), torch.from_numpy(s @ b))
    assert isinstance(xt, torch.Tensor) and _solve_residual(s, xt.numpy(), s @ b) < 1e-15
    sz = _spd(48, seed=16, complex_=True)
    bz = sz @ (rng.normal(size=48) + 1j * rng.normal(size=48))
    lz = tl.cholesky(sz, mode="fp64_int8_9", block=32, **CPU)
    np.testing.assert_array_equal(_u64(tl.cho_solve(lz, bz)), _u64(jl.cho_solve(lz, bz)))
    assert _solve_residual(sz, tl.cho_solve(torch.from_numpy(lz), bz), bz) < 1e-15


def test_engine_matvec_is_one_engine_call_at_the_residual_mode(monkeypatch):
    rng = np.random.default_rng(20)
    gemm = tl.gemm
    calls = []
    monkeypatch.setattr(tl, "gemm", lambda *args, **kw: calls.append((args[0].shape, kw["mode"]))
                        or gemm(*args, **kw))
    for complex_ in (False, True):
        a = torch.from_numpy(_matrix(600, seed=21, complex_=complex_))
        v, c = rng.normal(size=600), rng.normal(size=600)
        r = tl.engine_matvec(a, v, alpha=-1.0, beta=1.0, c=c)
        ref = c - a.numpy() @ v
        # one f64 rounding per element: the 1e-15 gate of the engine's products
        assert isinstance(r, np.ndarray) and r.shape == v.shape
        assert np.linalg.norm(r - ref) / np.linalg.norm(ref) < 1e-15
        rt = tl.engine_matvec(a, torch.from_numpy(np.stack([v, c], axis=1)).to(a.dtype))
        assert isinstance(rt, torch.Tensor) and rt.shape == (600, 2)
    assert calls == [((600, 600), "fp64_int8_12")] * 4


# ---------------------------------------------------------------------------
# errors, the untouched input, profiling
# ---------------------------------------------------------------------------


def test_permutation_matrix_is_factored_exactly_on_every_path():
    n = 64
    perm = np.random.default_rng(3).permutation(n)
    a = np.zeros((n, n))
    a[np.arange(n), perm] = np.arange(1, n + 1, dtype=float)
    lu, piv = tl.lu_factor(a, mode="fp64_int8_9", block=16, **CPU)
    assert _pa_lu_residual(a, lu, piv) == 0.0
    for panel in ("host", "device"):
        lu, piv = tl.lu_factor(torch.from_numpy(a), mode="fp64_int8_9", block=16, panel=panel)
        assert _pa_lu_residual(a, lu.numpy(), piv) == 0.0
        az = torch.from_numpy(a * (1 + 1j))
        lu, piv = tl.lu_factor(az, mode="fp64_int8_9", block=16, panel=panel)
        assert _pa_lu_residual(az.numpy(), lu.numpy(), piv) == 0.0


def test_singular_matrices_raise_on_every_path():
    ones = np.ones((32, 32))
    with pytest.raises(np.linalg.LinAlgError, match="zero pivot at column 1"):
        tl.lu_factor(ones, mode="fp64_int8_9", block=8, **CPU)
    with pytest.raises(np.linalg.LinAlgError, match="zero pivot at column 1"):
        tl.lu_factor(torch.from_numpy(ones), mode="fp64_int8_9", block=8)
    with pytest.raises(np.linalg.LinAlgError, match="zero pivot"):
        tl.lu_factor(torch.from_numpy(ones), mode="fp64_int8_9", block=8, panel="device")
    with pytest.raises(np.linalg.LinAlgError, match="zero pivot"):
        tl.lu_factor(torch.zeros(16, 16, dtype=torch.complex128), mode="fp64_int8_9", block=8,
                     panel="device")
    # the zero pivot sits in the last panel: the steps before it run
    late = np.zeros((48, 48))
    late[:32, :32] = _matrix(32, seed=9)
    for panel in ("host", "device"):
        with pytest.raises(np.linalg.LinAlgError, match="zero pivot"):
            tl.lu_factor(torch.from_numpy(late), mode="fp64_int8_9", block=16, panel=panel)
    eye = np.eye(64)
    eye[40, 40] = -1.0
    for arg, kw in ((eye, CPU), (torch.from_numpy(eye), {})):
        with pytest.raises(np.linalg.LinAlgError, match="not positive definite"):
            tl.cholesky(arg, mode="fp64_int8_9", block=16, **kw)


def test_front_doors_reject_bad_calls():
    for f in (tl.lu_factor, tl.cholesky):
        with pytest.raises(ValueError, match="square 2D"):
            f(np.ones((4, 5)), mode="fp64_int8_9", **CPU)
        with pytest.raises(ValueError, match="square 2D"):
            f(torch.ones(4, 5, dtype=torch.float64), mode="fp64_int8_9")
        with pytest.raises(ValueError, match="fixed fp64_int8"):
            f(np.eye(16), mode="dgemm", resident=True, **CPU)
        with pytest.raises(ValueError, match="fixed fp64_int8"):
            f(torch.eye(16, dtype=torch.float64), mode="fp64_int8_auto")
        with pytest.raises(ValueError, match="mesh requires the resident path"):
            f(np.eye(16), mode="fp64_int8_9", mesh=object(), resident=False)
        with pytest.raises(ValueError, match="host path"):
            f(torch.eye(16, dtype=torch.float64), mode="fp64_int8_9", resident=False)
        with pytest.raises(TypeError, match="float64 or complex128"):
            f(torch.eye(16), mode="fp64_int8_9")
    with pytest.raises(ValueError, match="panel must be"):
        tl.lu_factor(torch.eye(8, dtype=torch.float64), mode="fp64_int8_9", panel="bogus")
    hpd = _spd(32, seed=1, complex_=True)
    for arg, kw in ((torch.from_numpy(hpd), {}), (hpd, dict(resident=True, **CPU))):
        with pytest.raises(ValueError, match="real-only"):
            tl.cholesky(arg, mode="fp64_int8_9", block=16, **kw)


@pytest.mark.parametrize("panel,keys", [
    ("host", {"panel_pull_s", "panel_host_s", "device_update_s"}),
    ("device", {"panel_device_s", "device_update_s"}),
])
def test_profile_dict_is_filled(panel, keys):
    a = torch.from_numpy(_matrix(96, seed=35))
    prof = {}
    tl.lu_factor(a, mode="fp64_int8_9", block=32, panel=panel, profile=prof)
    assert set(prof) == keys and all(v >= 0 for v in prof.values())
    prof = {}
    tl.cholesky(torch.from_numpy(_spd(96, seed=36)), mode="fp64_int8_9", block=32, profile=prof)
    assert set(prof) == {"panel_host_s", "device_update_s"}


# ---------------------------------------------------------------------------
# faults of the reference that the port does not copy (ROADMAP.md queue 3)
# ---------------------------------------------------------------------------


def test_numpy_fallback_picks_complex_pivots_by_dcabs1(monkeypatch):
    """In column 0, |3+3j| = 4.24 < |4.4| but |re|+|im| = 6 > 4.4: LAPACK
    (and the scipy path) pivots on row 1, the modulus would pick row 2."""
    rng = np.random.default_rng(7)
    p = rng.uniform(-1, 1, (6, 3)) + 1j * rng.uniform(-1, 1, (6, 3))
    p[1, 0], p[2, 0] = 3 + 3j, 4.4
    lu_sp, ploc_sp = tl._panel_factor_local(p)
    assert ploc_sp[0] == 1
    lu_np, ploc_np = tl._numpy_panel_factor_local(p)
    np.testing.assert_array_equal(ploc_np, ploc_sp)
    np.testing.assert_allclose(lu_np, lu_sp, rtol=1e-13)
    _, ploc_ref = jl._numpy_panel_factor_local(p)
    assert ploc_ref[0] == 2  # the reference's fallback picks by modulus
    # an old scipy that rejects the tall panel falls through to that loop
    def old_scipy(x, **kw):
        raise ValueError("expected square matrix")

    monkeypatch.setattr(tl, "_sp_lu_factor", old_scipy)
    a = _matrix(48, seed=40, complex_=True)
    lu, piv = tl.lu_factor(a, mode="fp64_int8_9", block=16, **CPU)
    assert _pa_lu_residual(a, lu, piv) < 1e-14


def test_complex_device_panel_with_a_huge_pivot_stays_finite():
    """A pivot of modulus ~1e200: the unscaled complex division of the
    reference's traced panel squares it and overflows; LAPACK's does not."""
    a = _matrix(32, seed=8, complex_=True)
    a[5, 0] = 1e200 * (1 + 1j)
    for panel in ("host", "device"):
        lu, piv = tl.lu_factor(torch.from_numpy(a), mode="fp64_int8_9", block=16, panel=panel)
        assert piv[0] == 5 and torch.isfinite(torch.view_as_real(lu)).all()
        assert _pa_lu_residual(a, lu.numpy(), piv) < 1e-14
