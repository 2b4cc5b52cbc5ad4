"""``ozimmu_tpu_torch.gemm_batched`` against ``ozimmu_tpu.gemm_batched``:
the int8 modes bit for bit (real and complex, with and without c), one
AUTO mode for the batch, dgemm within its bound, and bad operands."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

B, M, K, N = 3, 17, 29, 11


def _u64(x):
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag])
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _operands(kind, dist="normal01", seed=0):
    cx = kind == "complex"
    a = generate_input(dist, (B, M, K), seed=seed, complex_=cx)
    b = generate_input(dist, (B, K, N), seed=seed + 1, complex_=cx)
    c = generate_input("normal01", (B, M, N), seed=seed + 2, complex_=cx)
    return a, b, c


def _cpu():
    return ozt.create(device="cpu")


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("ns", [3, 9, 18])
@pytest.mark.parametrize("with_c", [False, True])
def test_int8_batched_bits_match_reference(kind, ns, with_c):
    a, b, c = _operands(kind, seed=ns)
    alpha, beta = (1.5 - 0.5j, 0.5 + 0.25j) if kind == "complex" else (1.5, -0.5)
    kw = dict(mode=f"fp64_int8_{ns}", alpha=alpha, beta=beta if with_c else 0.0,
              c=c if with_c else None)
    got = ozt.gemm_batched(a, b, handle=_cpu(), **kw)
    assert isinstance(got, np.ndarray) and got.shape == (B, M, N)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm_batched(a, b, **kw)))
    # each matrix is its own 2-D GEMM (own row and column scales)
    two_d = ozt.gemm(a[1], b[1], handle=_cpu(), **dict(kw, c=c[1] if with_c else None))
    np.testing.assert_array_equal(_u64(got[1]), _u64(two_d))


@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("dist", ["urand01", "normal01"])
def test_auto_batched_picks_the_reference_mode(kind, dist):
    """No mode: one AUTO choice on the flattened batch; these operands get
    an int8 mode, so the bits are equal."""
    a, b, c = _operands(kind, dist=dist, seed=20)
    h, hr = _cpu(), oz.create()
    got = ozt.gemm_batched(a, b, c=c, beta=1.0, handle=h)
    want = oz.gemm_batched(a, b, c=c, beta=1.0, handle=hr)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    h.avg_mantissa_loss_threshold = hr.avg_mantissa_loss_threshold = 100.0
    got = ozt.gemm_batched(a, b, handle=h)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm_batched(a, b, handle=hr)))
    np.testing.assert_array_equal(_u64(got), _u64(ozt.gemm_batched(a, b, mode="fp64_int8_3",
                                                                   handle=h)))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_dgemm_batched_within_its_bound(kind):
    """k*2^-52*(|a|@|b|): each package's f64 product errs by at most half."""
    a, b, c = _operands(kind, dist="exp_rand-8", seed=30)
    alpha, beta = (2.0 - 1j, 0.5) if kind == "complex" else (2.0, 0.5)
    got = ozt.gemm_batched(a, b, mode="dgemm", alpha=alpha, beta=beta, c=c, handle=_cpu())
    want = oz.gemm_batched(a, b, mode="dgemm", alpha=alpha, beta=beta, c=c)
    bound = K * 2.0**-52 * (abs(alpha) * (np.abs(a) @ np.abs(b)) + abs(beta) * np.abs(c))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_tensor_batches_stay_tensors(kind):
    a, b, c = _operands(kind, seed=40)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = ozt.gemm_batched(ta, tb, c=tc, mode="fp64_int8_9", alpha=0.75, beta=2.0)
    assert isinstance(got, torch.Tensor) and got.shape == (B, M, N)
    want = oz.gemm_batched(a, b, c=c, mode="fp64_int8_9", alpha=0.75, beta=2.0)
    if kind == "complex":
        got = got.real.numpy() + 1j * got.imag.numpy()  # numpy's construction of a result
    np.testing.assert_array_equal(_u64(np.asarray(got)), _u64(want))


def test_batched_rejects_bad_operands():
    a, b, c = _operands("real", seed=50)
    h = _cpu()
    with pytest.raises(ValueError, match="batched shape mismatch"):
        ozt.gemm_batched(a[0], b[0], mode="fp64_int8_9", handle=h)
    with pytest.raises(ValueError, match="batched shape mismatch"):
        ozt.gemm_batched(a, b[:2], mode="fp64_int8_9", handle=h)
    with pytest.raises(ValueError, match="batched shape mismatch"):
        ozt.gemm_batched(a, a, mode="fp64_int8_9", handle=h)
    with pytest.raises(ValueError, match="c has shape"):
        ozt.gemm_batched(a, b, c=c[:, :, :3], beta=1.0, mode="fp64_int8_9", handle=h)
    with pytest.raises(ValueError, match="requires c"):
        ozt.gemm_batched(a, b, beta=1.0, mode="fp64_int8_9", handle=h)
    with pytest.raises(TypeError, match="numpy array like a"):
        ozt.gemm_batched(a, torch.from_numpy(b), mode="fp64_int8_9", handle=h)
    with pytest.raises(TypeError, match="float64 or complex128"):
        ozt.gemm_batched(torch.from_numpy(a).float(), torch.from_numpy(b).float(),
                         mode="fp64_int8_9", handle=h)
