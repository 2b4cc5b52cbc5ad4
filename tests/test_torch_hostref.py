"""The port's numpy model (``ozimmu_tpu_torch.hostref``) against the JAX
package's (``ozimmu_tpu.hostref``), bit for bit on every public function,
and the port's engine against the model: its split digits bitwise (the
counterpart of ``tests/test_device_engine.py::TestDeviceSplit``), its CPU
``gemm`` within 2 ulp (``TestDeviceGemm::test_matches_hostref_closely``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu import hostref as ref_host  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch import hostref  # noqa: E402
from ozimmu_tpu_torch.ops.split import ZERO_ROW_PEXP, row_exponent, split_with_row_exp  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

DISTS = ["urand01", "exp_rand-3"]
NS = [3, 9, 18]


def _u64(x):
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _special(dist: str, shape, seed: int) -> np.ndarray:
    """``dist`` with a zero row, a zero column, subnormals and -0.0."""
    x = generate_input(dist, shape, seed=seed)
    x[0, :] = 0.0
    x[:, 1] = 0.0
    x[3, 0] = 2.0**-1070
    x[4, 2] = -5e-324
    x[5, 3] = -0.0
    return x


def test_hostref_is_exported():
    assert ozt.hostref is hostref and "hostref" in ozt.__all__
    assert hostref.ZERO_ROW_PEXP == ref_host.ZERO_ROW_PEXP


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("ns", NS)
def test_split_and_reconstruct_equal_the_jax_model(dist, ns):
    x = _special(dist, (24, 40), seed=ns)
    b = ozt.bits_per_int8(40)
    got_d, got_p = hostref.split_fp64(x, ns, b)
    want_d, want_p = ref_host.split_fp64(x, ns, b)
    assert got_d.dtype == want_d.dtype == np.int8
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(_u64(hostref.reconstruct_fp64(got_d, got_p, b)),
                                  _u64(ref_host.reconstruct_fp64(want_d, want_p, b)))


def test_split_rejects_other_dtypes():
    with pytest.raises(TypeError):
        hostref.split_fp64(np.ones((2, 2), dtype=np.float32), 3, 7)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("ns", NS)
def test_gemm_core_equals_the_jax_model(dist, ns):
    a = _special(dist, (17, 33), seed=10 + ns)
    bm = generate_input(dist, (33, 12), seed=20 + ns)
    b = ozt.bits_per_int8(33)
    da, pa = hostref.split_fp64(a, ns, b)
    dbt, pb = hostref.split_fp64(np.ascontiguousarray(bm.T), ns, b)
    db = np.ascontiguousarray(np.swapaxes(dbt, 1, 2))
    got_s, got_e = hostref.gemm_core_fp64(da, pa, db, pb, b, 33)
    want_s, want_e = ref_host.gemm_core_fp64(da, pa, db, pb, b, 33)
    np.testing.assert_array_equal(_u64(got_s), _u64(want_s))
    np.testing.assert_array_equal(got_e, want_e)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("ns", NS)
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.5, 0.25), (2.0, 1.0)])
def test_gemm_equals_the_jax_model(dist, ns, alpha, beta):
    a = _special(dist, (21, 37), seed=ns)
    bm = generate_input(dist, (37, 15), seed=ns + 1)
    c = generate_input("normal01", (21, 15), seed=ns + 2)
    got = hostref.gemm_fp64(a, bm, ns, alpha=alpha, beta=beta, c=c)
    want = ref_host.gemm_fp64(a, bm, ns, alpha=alpha, beta=beta, c=c)
    np.testing.assert_array_equal(_u64(got), _u64(want))


@pytest.mark.parametrize("ns", NS)
@pytest.mark.parametrize("alpha,beta", [(1.0 + 0j, 0j), (0.5 - 2j, 1.5 + 0.25j)])
def test_zgemm_equals_the_jax_model(ns, alpha, beta):
    a = generate_input("normal01", (13, 29), seed=ns, complex_=True)
    bm = generate_input("normal01", (29, 11), seed=ns + 1, complex_=True)
    c = generate_input("normal01", (13, 11), seed=ns + 2, complex_=True)
    got = hostref.zgemm_fp64(a, bm, ns, alpha=alpha, beta=beta, c=c)
    want = ref_host.zgemm_fp64(a, bm, ns, alpha=alpha, beta=beta, c=c)
    np.testing.assert_array_equal(_u64(got.view(np.float64)), _u64(want.view(np.float64)))


def test_gemm_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        hostref.gemm_fp64(np.ones((3, 4)), np.ones((5, 2)), 9)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("ns", NS)
@pytest.mark.parametrize("axis", [1, 0])
def test_engine_split_equals_the_model(dist, ns, axis):
    """The port's split (plain version on the CPU; the CUDA kernel equals
    it bitwise on the card) gives the model's digits, A by rows (axis 1)
    and B by columns (axis 0); the exponents mean the same (the null-row
    sentinels are different numbers)."""
    x = _special(dist, (32, 40), seed=30 + ns)
    if axis == 0:
        x = np.ascontiguousarray(x.T)  # B [k, n]: the zero row becomes a zero column
    k = x.shape[axis]
    b = ozt.bits_per_int8(k)
    t = torch.from_numpy(x)
    digits, pexp = split_with_row_exp(t, row_exponent(t, axis), ns, b, axis)
    model_in = x if axis == 1 else np.ascontiguousarray(x.T)
    dh, ph = hostref.split_fp64(model_in, ns, b)
    want = dh if axis == 1 else np.swapaxes(dh, 1, 2)
    np.testing.assert_array_equal(digits.numpy(), want)
    pexp = pexp.numpy().astype(np.int64)
    np.testing.assert_array_equal(pexp == ZERO_ROW_PEXP, ph == hostref.ZERO_ROW_PEXP)
    live = ph != hostref.ZERO_ROW_PEXP
    np.testing.assert_array_equal(pexp[live], ph[live])


@pytest.mark.parametrize("ns", [8, 9, 12])
@pytest.mark.parametrize("dist", ["normal01", "exp_rand-3"])
def test_engine_gemm_is_within_two_ulp_of_the_model(ns, dist):
    a = generate_input(dist, (48, 64), seed=5)
    bm = generate_input(dist, (64, 32), seed=6)
    got = ozt.gemm(a, bm, mode=f"fp64_int8_{ns}", device="cpu")
    # both are ~correctly-rounded recombinations; allow 2 ulp
    np.testing.assert_allclose(got, hostref.gemm_fp64(a, bm, ns), rtol=5e-16, atol=0)
