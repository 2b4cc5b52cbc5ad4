"""The epilogue and the complex fold on the CPU: the dispatch runs the plain
versions on CPU tensors and never reaches the CUDA library; the CUDA
wrappers refuse CPU tensors; the fold's plan (what the kernel runs),
interpreted in torch, equals the plain fold and the JAX package's bit for
bit; the column-chunked cores write their panels in place; and a product
with k = 0 returns beta * c (BLAS), or zeros without reading c."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu.core import gemm as ref_core  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu_torch import native  # noqa: E402
from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.core.bits import from_f64x_planes  # noqa: E402
from ozimmu_tpu_torch.ops import epilogue_cuda  # noqa: E402
from ozimmu_tpu_torch.ops.pack import unpack_f64  # noqa: E402

M, N = 9, 13


def _u64(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag])
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _passes(seed: int, m: int = M, n: int = N):
    """Four (S, E) pass results: exact triples of f64 values in the normal
    range (XLA:CPU flushes f32 subnormals, torch keeps them)."""
    rng = np.random.default_rng(seed)
    return [unpack_f64(torch.from_numpy(rng.uniform(-4, 4, (m, n)))) for _ in range(4)]


def _c_parts(seed: int, kind: str):
    """c's planes: absent, contiguous, or strided windows of a wider matrix."""
    if kind == "absent":
        return None, None
    rng = np.random.default_rng(seed)
    if kind == "given":
        return tuple(torch.from_numpy(rng.uniform(-2, 2, (M, N))) for _ in range(2))
    wide = [torch.from_numpy(rng.uniform(-2, 2, (M + 3, 2 * N + 1))) for _ in range(2)]
    return tuple(w[2:2 + M, 1::2] for w in wide)


def _no_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(native, "lib", refuse)


ALPHAS = [0.0, 1.0, -1.0, 2.5, 0.5 - 1.5j]
BETAS = [0.0, 1.0, -1.0, 0.75, 1.25 + 0.5j]


@pytest.mark.parametrize("c_kind", ["absent", "given", "strided"])
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_zfold_plan_equals_the_plain_fold_and_the_reference(alpha, beta, c_kind):
    SEs = _passes(seed=7)
    c_re, c_im = _c_parts(seed=8, kind=c_kind)
    plan = epilogue_cuda.zfold_plan(alpha, beta)
    got = epilogue_cuda.zfold_plain(SEs, plan, c_re, c_im)
    want = core._zfold_block(SEs, M, N, complex(alpha), complex(beta), c_re, c_im, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_u64(g), _u64(w))
    jSEs = [(tuple(jnp.asarray(s.numpy()) for s in S), jnp.asarray(E.numpy())) for S, E in SEs]
    jc = [None if x is None else F64X.from_numpy(np.ascontiguousarray(x.numpy()))
          for x in (c_re, c_im)]
    ref = ref_core._zfold_passes(jSEs, M, N, complex(alpha), complex(beta), *jc)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_u64(g), _u64(from_f64x_planes(r.hi, r.lo)))


def test_zfold_plan_steps_follow_the_fold_order():
    """beta * c first (c_re by beta, c_im by i * beta), then each pass of
    ZGEMM_PASSES by -alpha, alpha, i * alpha, i * alpha, real target
    first; zero factors (signed zeros too) add no step."""
    plan = epilogue_cuda.zfold_plan(2 - 0.5j, 0.25 + 1j)
    C_RE, C_IM = epilogue_cuda.C_RE, epilogue_cuda.C_IM
    assert not plan.init_from_c and len(plan.steps) == epilogue_cuda.MAX_STEPS
    assert [(s.src, s.dst) for s in plan.steps] == [
        (C_RE, 0), (C_RE, 1), (C_IM, 0), (C_IM, 1),
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)]
    values = [sum(s.triple) * 2.0**s.exp for s in plan.steps]
    assert values == [0.25, 1.0, -1.0, 0.25, -2.0, 0.5, 2.0, -0.5, 0.5, 2.0, 0.5, 2.0]
    plain = epilogue_cuda.zfold_plan(1.0, 0.0)
    assert [(s.src, s.dst) for s in plain.steps] == [(0, 0), (1, 0), (2, 1), (3, 1)]
    assert epilogue_cuda.zfold_plan(1.0, 1.0).init_from_c
    assert epilogue_cuda.zfold_plan(0.0, 0.0).steps == ()


@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.5, 0.0), (1.0, 1.0), (2.0, -0.5),
                                        (0.0, 1.5)])
def test_dispatch_on_cpu_runs_the_plain_epilogue(monkeypatch, alpha, beta):
    """On CPU tensors ``_epilogue_SE`` (2-D, a batch view, into a strided
    output panel) is the plain ``_epilogue_block``, and never loads the
    CUDA library."""
    _no_library(monkeypatch)
    S, E = _passes(seed=11)[0]
    c = _c_parts(seed=12, kind="strided")[0] if beta != 0.0 else None
    want = core._epilogue_block(S, E, alpha, beta, c)
    np.testing.assert_array_equal(_u64(core._epilogue_SE(S, E, alpha, beta, c)), _u64(want))
    wide = torch.full((M, N + 5), 7.0, dtype=torch.float64)
    panel = wide[:, 2:2 + N]
    assert core._epilogue_SE(S, E, alpha, beta, c, panel) is panel
    np.testing.assert_array_equal(_u64(wide[:, 2:2 + N]), _u64(want))
    assert (wide[:, :2] == 7.0).all() and (wide[:, 2 + N:] == 7.0).all()
    batch = [t.reshape(3, 3, N) for t in (*S, E)]
    cb = None if c is None else c.reshape(3, 3, N)
    got = core._epilogue_SE(tuple(batch[:3]), batch[3], alpha, beta, cb)
    np.testing.assert_array_equal(_u64(got.reshape(M, N)), _u64(want))


def test_dispatch_on_cpu_runs_the_plain_fold(monkeypatch):
    _no_library(monkeypatch)
    SEs = _passes(seed=13)
    c_re, c_im = _c_parts(seed=14, kind="strided")
    args = (2 - 0.5j, 0.25 + 1j, c_re, c_im, "cpu")
    want = core._zfold_block(SEs, M, N, *args)
    out = tuple(torch.zeros((M, N + 2), dtype=torch.float64)[:, 1:1 + N] for _ in range(2))
    for got in (core._zfold_passes(SEs, M, N, *args), core._zfold_passes(SEs, M, N, *args, out)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_u64(g), _u64(w))
    assert all(o.data_ptr() == g.data_ptr() for o, g in zip(out, core._zfold_passes(
        SEs, M, N, *args, out)))


def test_engine_on_cpu_never_loads_the_library(monkeypatch):
    """A whole GEMM, ZGEMM and batch on CPU tensors (plain split,
    recombine and epilogue)."""
    _no_library(monkeypatch)
    rng = np.random.default_rng(15)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in ((M, 20), (20, N), (M, N)))
    ozt.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=-0.5, c=c)
    ozt.gemm(a + 0j, b * 1j, mode="fp64_int8_9", alpha=1j, beta=0.5, c=c + 0j)
    ozt.gemm_batched(a[None], b[None], mode="fp64_int8_9", beta=1.0, c=c[None])


def test_other_devices_are_refused():
    S, E = (tuple(torch.zeros((2, 3), device="meta") for _ in range(3)),
            torch.zeros((2, 3), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        core._epilogue_SE(S, E, 1.0, 0.0, None)
    with pytest.raises(ValueError, match="unsupported device"):
        core._zfold_passes([(S, E)] * 4, 2, 3, 1 + 0j, 0j, None, None, "meta")


def test_cuda_wrappers_raise_on_cpu_tensors(monkeypatch):
    _no_library(monkeypatch)
    before = (epilogue_cuda.LAUNCHES, epilogue_cuda.ZFOLD_LAUNCHES)
    SEs = _passes(seed=16)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue_cuda.epilogue(*SEs[0], 1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        epilogue_cuda.zfold(SEs, 1.0, 0.0)
    assert (epilogue_cuda.LAUNCHES, epilogue_cuda.ZFOLD_LAUNCHES) == before


def test_launch_grid():
    assert epilogue_cuda.launch_grid(1, 132) == 1
    assert epilogue_cuda.launch_grid(256 * 10 + 1, 132) == 11
    assert epilogue_cuda.launch_grid(8192 * 8192, 132) == 132 * epilogue_cuda.BLOCKS_PER_SM
    with pytest.raises(ValueError):
        epilogue_cuda.launch_grid(0, 132)


def test_sub_batches_hold_no_epilogue_temporaries_on_the_card(monkeypatch):
    """The kernel holds nothing beyond the working-set model, so a batch
    on a CUDA device takes larger sub-batches than the plain epilogue's
    estimate allows on the CPU (a 1 MiB budget is read from the
    environment, with no card)."""
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "1")
    on_cpu = core._sub_batches(64, 32, 32, 32, 9, False, "cpu")
    on_card = core._sub_batches(64, 32, 32, 32, 9, False, "cuda")
    assert core._temp_bytes(False, "cuda") == core._temp_bytes(True, "cuda") == 0
    assert len(on_card) < len(on_cpu)
    per = ozt.schedule.working_set_bytes_chunked(32, 32, 32, 9, 1)
    assert on_card[0] == slice(0, (1 << 20) // per)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("chunks", [2, 3])
def test_chunked_cores_write_panels_in_place_bitwise(complex_, chunks):
    """``gemm_f64`` / ``zgemm_f64`` in column panels, each panel's epilogue
    writing through ``out[:, j0:j1]``, equal the unchunked engine."""
    rng = np.random.default_rng(17)
    m, k, n = 11, 37, 29
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s))  # noqa: E731
    if complex_:
        ops = [mk(m, k), mk(m, k), mk(k, n), mk(k, n)]
        kw = dict(alpha=1.5 - 0.5j, beta=0.5 + 1j, c_re=mk(m, n), c_im=mk(m, n))
        one = ozt.zgemm_f64(*ops, 9, n_chunks=1, **kw)
        got = ozt.zgemm_f64(*ops, 9, n_chunks=chunks, **kw)
    else:
        ops = [mk(m, k), mk(k, n)]
        kw = dict(alpha=-2.0, beta=0.25, c=mk(m, n + 4)[:, 2:2 + n])
        one = (ozt.gemm_f64(*ops, 9, n_chunks=1, **kw),)
        got = (ozt.gemm_f64(*ops, 9, n_chunks=chunks, **kw),)
    for g, w in zip(got, one):
        np.testing.assert_array_equal(_u64(g), _u64(w))


def _nan_c(rng, shape, complex_=False):
    c = rng.standard_normal(shape) + (1j * rng.standard_normal(shape) if complex_ else 0)
    c.reshape(-1)[0] = np.nan
    return c


@pytest.mark.parametrize("beta", [0.0, 1.5, -0.25])
@pytest.mark.parametrize("mode", ["fp64_int8_9", "fp64_int8_auto", "dgemm", "sgemm"])
def test_k0_real_is_beta_c(mode, beta):
    """k = 0 in every mode: beta * c bitwise (numpy's product), zeros where
    beta == 0 with NaN in c (c not read), and zeros where c is None."""
    rng = np.random.default_rng(18)
    a, b = np.zeros((5, 0)), np.zeros((0, 7))
    c = _nan_c(rng, (5, 7))
    got = ozt.gemm(a, b, mode=mode, alpha=3.0, beta=beta, c=c, device="cpu")
    want = np.zeros((5, 7)) if beta == 0.0 else beta * c
    np.testing.assert_array_equal(_u64(got), _u64(want))
    got_t = ozt.gemm(torch.from_numpy(a), torch.from_numpy(b), mode=mode, beta=beta,
                     c=torch.from_numpy(c))
    np.testing.assert_array_equal(_u64(got_t), _u64(want))
    np.testing.assert_array_equal(
        _u64(ozt.gemm(a, b, mode=mode, device="cpu")), _u64(np.zeros((5, 7))))
    np.testing.assert_array_equal(
        _u64(ozt.gemm(a.T, b.T, mode=mode, op_a="T", op_b="T", beta=beta, c=c, device="cpu")),
        _u64(want))
    with pytest.raises(ValueError, match="c has shape"):
        ozt.gemm(a, b, mode=mode, beta=beta, c=c.T.copy(), device="cpu")


@pytest.mark.parametrize("beta", [0.0, 1.0, 0.5 - 2j])
def test_k0_complex_and_batched_is_beta_c(beta):
    """Complex (``re = br*cr - bi*ci``, ``im = br*ci + bi*cr``, each one
    IEEE operation, against numpy's same formula) and batched, real and
    complex; the engine's own entries too."""
    rng = np.random.default_rng(19)
    c = _nan_c(rng, (5, 7), complex_=True)
    cb = _nan_c(rng, (3, 5, 7), complex_=True)

    def want(cc):
        if beta == 0:
            return np.zeros(cc.shape, dtype=np.complex128)
        br, bi = complex(beta).real, complex(beta).imag
        return (br * cc.real - bi * cc.imag) + 1j * (br * cc.imag + bi * cc.real)

    a, b = np.zeros((5, 0), dtype=np.complex128), np.zeros((0, 7), dtype=np.complex128)
    got = ozt.gemm(a, b, mode="fp64_int8_9", beta=beta, c=c, device="cpu")
    np.testing.assert_array_equal(_u64(got), _u64(want(c)))
    got = ozt.gemm_batched(np.zeros((3, 5, 0)) + 0j, np.zeros((3, 0, 7)) + 0j,
                           mode="fp64_int8_9", beta=beta, c=cb, device="cpu")
    np.testing.assert_array_equal(_u64(got), _u64(want(cb)))
    real = _nan_c(rng, (3, 5, 7))
    got = ozt.gemm_batched(np.zeros((3, 5, 0)), np.zeros((3, 0, 7)), mode="fp64_int8_9",
                           beta=complex(beta).real, c=real, device="cpu")
    br = complex(beta).real
    np.testing.assert_array_equal(_u64(got), _u64(np.zeros_like(real) if br == 0 else br * real))
    z = torch.zeros((5, 0), dtype=torch.float64)
    zt = torch.zeros((0, 7), dtype=torch.float64)
    cr, ci = (torch.from_numpy(np.ascontiguousarray(p)) for p in (c.real, c.imag))
    re, im = ozt.zgemm_f64(z, z, zt, zt, 9, beta=beta, c_re=cr, c_im=ci)
    np.testing.assert_array_equal(_u64(re.numpy() + 1j * im.numpy()), _u64(want(c)))
    np.testing.assert_array_equal(
        _u64(ozt.gemm_f64(z, zt, 9, beta=2.0, c=cr)), _u64(2.0 * c.real))


def test_crafted_triples_reach_the_corner_cases():
    """``testing.crafted_triples`` (the inputs the kernels are held to on
    the card) is finite and, through the plain epilogue, reaches f32
    subnormal tails, overflow to inf, f64 subnormals, signed zeros and
    exponents below the empty accumulator."""
    from ozimmu_tpu_torch.testing import crafted_triples

    S, E, c = crafted_triples(64, 37, seed=1)
    assert [t.dtype for t in S] == [torch.float32] * 3 and E.dtype == torch.int32
    assert all(bool(torch.isfinite(t).all()) for t in (*S, c))
    tiny = torch.finfo(torch.float32).tiny
    assert bool(((S[1].abs() < tiny) & (S[1] != 0)).any())
    assert bool((E < core._EMPTY_EXP).any())
    out = core._epilogue_block(S, E, -1.5, 0.25, c).numpy()
    assert np.isinf(out).any() and (np.abs(out[out != 0]) < 2.0**-1022).any()
    assert (np.signbit(out) & (out == 0)).any()
