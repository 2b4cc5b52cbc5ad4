"""The plain references against numpy's long double (64-bit significand on
x86) at small sizes."""

import numpy as np
import pytest
import torch

from reference import dd, gemm, hpl

LD = np.longdouble


def _operands(seed, m, k, n, signed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((m, k), dtype=torch.float64, generator=g)
    b = torch.rand((k, n), dtype=torch.float64, generator=g)
    if signed:
        a, b = a - 0.5, b * 2 ** 20 - 2 ** 19
    return a, b


def _exact(a, b):
    return a.numpy().astype(LD) @ b.numpy().astype(LD)


pytestmark = pytest.mark.skipif(np.finfo(LD).nmant < 63, reason="long double is float64 here")


@pytest.mark.parametrize("signed", [False, True])
def test_double_double_dot_is_far_below_one_ulp(signed):
    a, b = _operands(1, 8, 300, 6, signed)
    h, l = dd.sum_last(*dd.two_prod(a.unsqueeze(1), b.T.unsqueeze(0)))
    exact = _exact(a, b)
    den = (a.abs() @ b.abs()).numpy().astype(LD)
    got = h.numpy().astype(LD) + l.numpy().astype(LD)
    assert np.max(np.abs(got - exact) / den) < 3e-18 * 300


@pytest.mark.parametrize("signed", [False, True])
def test_entry_and_rowsum_err_of_the_rounded_exact_product(signed):
    a, b = _operands(2, 40, 257, 33, signed)
    exact = _exact(a, b)
    c = torch.from_numpy(exact.astype(np.float64))
    den = (a.abs() @ b.abs()).numpy()
    idx = gemm.sample(tuple(c.shape), 500, seed=3)
    # the exactly rounded product is off by at most half an ulp of each entry
    assert gemm.entry_err(a, b, c, idx) <= 2.0**-53 * np.max(np.abs(exact.astype(float)) / den)
    assert gemm.rowsum_err(a, b, c) < 2.0**-52
    # float64 matmul, summed in float64, is worse than that
    worse = gemm.numbers(a, b, a @ b, 2000, seed=3)
    assert worse["entry_err"] > 0


def test_rowsum_err_sees_one_entry_changed_anywhere():
    a, b = _operands(4, 50, 200, 70, False)
    c = torch.from_numpy(_exact(a, b).astype(np.float64))
    base = gemm.rowsum_err(a, b, c)
    c[37, 61] *= 1 + 2.0**-30
    assert gemm.rowsum_err(a, b, c) > 50 * base
    # a batch: every matrix's rows are read
    ab, bb = torch.stack([a, a * 2]), torch.stack([b, b])
    cb = torch.stack([torch.from_numpy(_exact(a, b).astype(np.float64))] * 2)
    cb[1] *= 2
    assert gemm.rowsum_err(ab, bb, cb) == pytest.approx(base, abs=1e-18)
    cb[1, 3, 5] = 0.0
    assert gemm.rowsum_err(ab, bb, cb) > 1e-6


def test_sample_covers_every_matrix_of_a_batch():
    bi, ri, ci = gemm.sample((4, 100, 90), 4096, seed=5)
    assert set(bi.tolist()) == {0, 1, 2, 3}
    assert ri.max() < 100 and ci.max() < 90
    assert all((x == y).all() for x, y in zip(gemm.sample((4, 100, 90), 4096, 5), (bi, ri, ci)))


def test_gemm_control_is_float32_without_tf32():
    a, b = _operands(6, 64, 64, 64, False)
    c = gemm.control(a, b)
    assert c.dtype == torch.float64
    assert torch.equal(c, (a.float() @ b.float()).double())
    assert gemm.numbers(a, b, c, 256, seed=6)["entry_err"] > 1e-9


def test_hpl_scaled_residual_is_hpls_formula():
    g = torch.Generator().manual_seed(8)
    n = 200
    a = torch.rand((n, n), dtype=torch.float64, generator=g) - 0.5
    b = torch.rand((n,), dtype=torch.float64, generator=g) - 0.5
    x = torch.linalg.solve(a, b)
    an, xn, bn = a.numpy().astype(LD), x.numpy().astype(LD), b.numpy().astype(LD)
    want = np.max(np.abs(an @ xn - bn)) / (
        2.0**-53 * (np.max(np.abs(an).sum(1)) * np.max(np.abs(xn)) + np.max(np.abs(bn))) * n)
    got = hpl.scaled_residual(a, x, b)
    assert got < 16
    assert got == pytest.approx(float(want), rel=0.5, abs=1e-3)
    assert hpl.numbers(a, hpl.control(a, b), b)["hpl_resid"] > 1e4
    y = x.clone()
    y[7] *= 1 + 1e-6
    assert hpl.scaled_residual(a, y, b) > 16
