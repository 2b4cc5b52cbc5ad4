"""ozimmu_tpu_torch.ops.mantissa_loss against ozimmu_tpu.ops.mantissa_loss:
the int64 loss totals bit for bit, the histogram form against the literal
form, the complex counter, AUTO's choice and its fallback policy."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import mantissa_loss as ref  # noqa: E402
from ozimmu_tpu_torch.core.bits import exponent_field  # noqa: E402
from ozimmu_tpu_torch.ops import mantissa_loss as port  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input, loss_totals_literal  # noqa: E402

M, K, N = 33, 47, 65


def _special():
    """Zero rows and columns, a row of subnormals (group max exponent 0),
    subnormals and +-0.0 among normals, and extreme magnitudes."""
    x = generate_input("normal01", (M, K), seed=9)
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, :] = -0.0
    x[5, 5] = 1e300
    x[6, 6] = 2.2250738585072014e-308
    x[7, :] = 1e-310
    return x


INPUTS = {
    "urand01": lambda: generate_input("urand01", (M, K), seed=1),
    "normal01": lambda: generate_input("normal01", (M, K), seed=2),
    "exp_rand-8": lambda: generate_input("exp_rand-8", (M, K), seed=3),
    "special": _special,
}


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("b", [7, 5])
def test_totals_bits_match_reference(name, axis, b):
    x = INPUTS[name]()
    t = torch.from_numpy(x)
    got = port.mantissa_loss_totals(t, b, axis)
    assert got.dtype == torch.int64 and got.shape == (16,)
    want = np.asarray(ref.mantissa_loss_totals(F64X.from_numpy(x), b, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    e = torch.amax(exponent_field(t), dim=axis)
    np.testing.assert_array_equal(loss_totals_literal(t, e, b, axis).numpy(), got.numpy())


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shift", [3, -60])
def test_totals_against_an_external_group_exponent(axis, shift):
    """The distributed estimator's split: a group maximum from outside
    (here the local one moved up, or far down so that some elements need
    fewer than 0 bits), and zero groups."""
    x = INPUTS["exp_rand-8"]()
    t = torch.from_numpy(x)
    e = torch.amax(exponent_field(t), dim=axis) + shift
    e = torch.clamp(e, min=1)
    e[::5] = 0
    got = port.loss_totals_with_group_exp(t, e, 7, axis)
    want = np.asarray(ref.loss_totals_with_group_exp(
        F64X.from_numpy(x), jnp.asarray(e.numpy()), 7, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(loss_totals_literal(t, e, 7, axis).numpy(), got.numpy())


@pytest.mark.parametrize("b_is_cols", [True, False])
def test_complex_loss_totals(b_is_cols):
    a = generate_input("exp_rand-8", (M, K), seed=4, complex_=True)
    b = generate_input("normal01", (K, N) if b_is_cols else (N, K), seed=5, complex_=True)
    planes = [np.ascontiguousarray(p) for p in (a.real, a.imag, b.real, b.imag)]
    got = port.complex_loss_totals(*(torch.from_numpy(p) for p in planes), K, b_is_cols)
    want = np.asarray(ref.complex_loss_totals(*(F64X.from_numpy(p) for p in planes), K, b_is_cols))
    np.testing.assert_array_equal(got.numpy(), want)
    for thr in (0.0, 3.0, 100.0):
        assert port.auto_mode_select_complex(
            *(torch.from_numpy(p) for p in planes), K, thr, b_is_cols
        ).value == ref.auto_mode_select_complex(
            *(F64X.from_numpy(p) for p in planes), K, thr, b_is_cols).value


@pytest.mark.parametrize("dist", ["urand01", "exp_rand-8"])
@pytest.mark.parametrize("op_a,op_b", [("N", "N"), ("T", "N"), ("N", "T")])
@pytest.mark.parametrize("threshold", [0.0, 100.0])
def test_auto_mode_select_matches_reference(dist, op_a, op_b, threshold):
    a = generate_input(dist, (M, K) if op_a == "N" else (K, M), seed=6)
    b = generate_input(dist, (K, N) if op_b == "N" else (N, K), seed=7)
    want = oz.auto_mode_select(a, b, op_a=op_a, op_b=op_b, threshold=threshold).value
    got = ozt.auto_mode_select(a, b, op_a=op_a, op_b=op_b, threshold=threshold, device="cpu")
    assert got.value == want
    t = ozt.auto_mode_select(torch.from_numpy(a), torch.from_numpy(b), op_a=op_a, op_b=op_b,
                             threshold=threshold)
    assert t is got


def test_auto_mode_select_reads_the_handle_threshold():
    a = generate_input("urand01", (M, K), seed=8)
    b = generate_input("urand01", (K, N), seed=9)
    h = ozt.create(device="cpu")
    ozt.set_auto_mantissa_loss_threshold(h, 100.0)
    assert ozt.get_auto_mantissa_loss_threshold(h) == 100.0
    assert ozt.auto_mode_select(a, b, handle=h) is ozt.ComputeMode.FP64_INT8_3
    with pytest.raises(TypeError, match="real"):
        ozt.auto_mode_select(a + 1j, b, handle=h)


@pytest.mark.parametrize("env,mode", [
    ("dgemm", ozt.ComputeMode.DGEMM),
    ("native", ozt.ComputeMode.DGEMM),
    ("int8_18", ozt.ComputeMode.FP64_INT8_18),
    ("deepest", ozt.ComputeMode.FP64_INT8_18),
    ("auto", ozt.ComputeMode.DGEMM),
    (None, ozt.ComputeMode.DGEMM),
])
def test_auto_fallback_policy(monkeypatch, capsys, env, mode):
    """Torch has IEEE f64 on every device: the policy is dgemm; the env
    overrides it; the choice is logged."""
    if env is None:
        monkeypatch.delenv("OZIMMU_AUTO_FALLBACK", raising=False)
    else:
        monkeypatch.setenv("OZIMMU_AUTO_FALLBACK", env)
    monkeypatch.setenv("OZIMMU_INFO", "1")
    assert port.auto_fallback_mode() is mode
    assert ref.auto_fallback_mode().value == mode.value  # the JAX package on its CPU backend
    assert f"falling back to {mode.value}" in capsys.readouterr().out
    totals = np.full(16, 10, dtype=np.int64)
    assert port.select_mode_from_totals(totals, 1.0, 5.0) is mode
    assert port.select_mode_from_totals(totals, 1.0, 10.0) is ozt.ComputeMode.FP64_INT8_3


def test_fallback_to_int8_18_runs_it(monkeypatch):
    """Operands AUTO rejects at threshold 0: with OZIMMU_AUTO_FALLBACK=int8_18
    both packages run fp64_int8_18, bit for bit."""
    monkeypatch.setenv("OZIMMU_AUTO_FALLBACK", "int8_18")
    a = generate_input("exp_rand-8", (M, K), seed=10)
    b = generate_input("exp_rand-8", (K, N), seed=11)
    assert ozt.auto_mode_select(a, b, threshold=0.0, device="cpu") is ozt.ComputeMode.FP64_INT8_18
    got = ozt.gemm(a, b, device="cpu", handle=ozt.create(device="cpu"))
    want = oz.gemm(a, b, handle=oz.create())
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
