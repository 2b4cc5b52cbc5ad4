"""The sgemm (f32 demotion) mode against ``ozimmu_tpu``: the demoted
operands bit for bit, the products within the f32 bound, alpha/beta,
batches, and the caller's float32 matmul precision kept out."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu.core import api as ref_api  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu_torch.core.api import _f64_to_f32  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

M, K, N = 33, 47, 65
U32 = 2.0**-24  # f32 unit roundoff


def _bound(a, b, scale=1.0):
    """2*k*u32*(|a|@|b|): each package's f32 product errs by at most
    k*u32*(|a|@|b|) (|a| the complex modulus for complex operands)."""
    return 2 * a.shape[-1] * U32 * scale * (np.abs(a) @ np.abs(b))


def _cpu():
    return ozt.create(device="cpu")


@pytest.mark.parametrize("dist", ["urand01", "normal01", "exp_rand-8"])
def test_demoted_operands_bits_match_reference(dist):
    """Inputs in the f32 normal range (XLA:CPU flushes f32 subnormals,
    ROADMAP.md queue 3)."""
    x = generate_input(dist, (M, K), seed=1)
    got = _f64_to_f32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(ref_api._f64x_to_f32(F64X.from_numpy(x)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("op_a,op_b", [("N", "N"), ("T", "N"), ("N", "C")])
def test_real_sgemm_within_the_f32_bound(op_a, op_b):
    a = generate_input("normal01", (M, K) if op_a == "N" else (K, M), seed=2)
    b = generate_input("normal01", (K, N) if op_b == "N" else (N, K), seed=3)
    got = ozt.gemm(a, b, mode="sgemm", op_a=op_a, op_b=op_b, handle=_cpu())
    want = oz.gemm(a, b, mode="sgemm", op_a=op_a, op_b=op_b)
    la = a if op_a == "N" else a.T
    lb = b if op_b == "N" else b.T
    assert (np.abs(got - want) <= _bound(la, lb)).all()
    # the result is an exactly widened f32
    np.testing.assert_array_equal(got.astype(np.float32).astype(np.float64), got)


def test_complex_sgemm_within_the_f32_bound():
    a = generate_input("normal01", (M, K), seed=4, complex_=True)
    b = generate_input("normal01", (K, N), seed=5, complex_=True)
    got = ozt.gemm(a, b, mode="sgemm", handle=_cpu())
    want = oz.gemm(a, b, mode="sgemm")
    assert got.dtype == np.complex128
    assert (np.abs(got - want) <= _bound(a, b)).all()


@pytest.mark.parametrize("alpha,beta", [(1.5, 0.0), (1.0, -0.25), (-2.0, 0.75)])
def test_real_sgemm_alpha_beta(alpha, beta):
    """alpha/beta fold exactly on the widened f32 product, in both."""
    a = generate_input("normal01", (M, K), seed=6)
    b = generate_input("normal01", (K, N), seed=7)
    c = generate_input("normal01", (M, N), seed=8)
    got = ozt.gemm(a, b, mode="sgemm", alpha=alpha, beta=beta, c=c, handle=_cpu())
    want = oz.gemm(a, b, mode="sgemm", alpha=alpha, beta=beta, c=c)
    tol = _bound(a, b, abs(alpha)) + 2.0**-52 * np.abs(want)
    assert (np.abs(got - want) <= tol).all()


def test_complex_sgemm_alpha_beta():
    """alpha/beta applied in f32 on the f32 products and the demoted c
    (the reference's cuComplex scalars); each f32 step rounds once more."""
    a = generate_input("normal01", (M, K), seed=9, complex_=True)
    b = generate_input("normal01", (K, N), seed=10, complex_=True)
    c = generate_input("normal01", (M, N), seed=11, complex_=True)
    alpha, beta = 2 - 0.5j, 0.25 + 1j
    got = ozt.gemm(a, b, mode="sgemm", alpha=alpha, beta=beta, c=c, handle=_cpu())
    want = oz.gemm(a, b, mode="sgemm", alpha=alpha, beta=beta, c=c)
    tol = (_bound(a, b, 2 * abs(alpha)) + 8 * U32 * abs(beta) * np.abs(c))
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("with_c", [False, True])
def test_batched_sgemm(kind, with_c):
    cx = kind == "complex"
    a = generate_input("normal01", (3, M, K), seed=12, complex_=cx)
    b = generate_input("normal01", (3, K, N), seed=13, complex_=cx)
    c = generate_input("normal01", (3, M, N), seed=14, complex_=cx) if with_c else None
    alpha, beta = (1.5 - 0.5j, 0.5j) if cx else (1.5, -0.5)
    kw = dict(mode="sgemm", alpha=alpha, beta=beta if with_c else 0.0, c=c)
    got = ozt.gemm_batched(a, b, handle=_cpu(), **kw)
    want = oz.gemm_batched(a, b, **kw)
    assert got.shape == (3, M, N) and got.dtype == want.dtype
    tol = _bound(a, b, 2 * abs(alpha)) + (8 * U32 * abs(beta) * np.abs(c) if with_c else 0.0)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_callers_matmul_precision_does_not_leak_in(precision):
    """A caller's global float32 matmul precision changes neither the
    sgemm result nor survives altered: it is restored after the call."""
    a = generate_input("normal01", (M, K), seed=15)
    b = generate_input("normal01", (K, N), seed=16)
    want = ozt.gemm(a, b, mode="sgemm", handle=_cpu())
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        got = ozt.gemm(a, b, mode="sgemm", handle=_cpu())
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
