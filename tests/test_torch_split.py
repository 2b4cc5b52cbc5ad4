"""The port's split (plain PyTorch version, CPU) against ozimmu_tpu's:
digit planes, row exponents and scales, bitwise — plus one small case
against the Pallas kernel itself in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import split as R  # noqa: E402
from ozimmu_tpu.ops.split_pallas import split_digits_pallas  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch.core import bits  # noqa: E402
from ozimmu_tpu_torch.ops import split as P  # noqa: E402


def _special():
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0  # zero row
    x[:, 0] = 0.0  # zero col
    x[1, 1] = 5e-324  # smallest subnormal
    x[2, 2] = -1e-310  # negative subnormal
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, 5] = -1e-300
    return x


MATRICES = {
    "exp_rand-8": lambda: generate_input("exp_rand-8", (48, 72), seed=7),
    "special": _special,
    "all_zero": lambda: np.zeros((16, 40)),
    "subnormal_only": lambda: np.full((8, 24), 3e-320) * np.sign(np.arange(-96, 96).reshape(8, 24) + 0.5),
}


@pytest.mark.parametrize("ns,b", [(3, 7), (9, 7), (9, 5), (18, 7)])
@pytest.mark.parametrize("name", list(MATRICES))
def test_split_matches_reference(name, ns, b):
    x = MATRICES[name]()
    xt = torch.from_numpy(x)
    fx = F64X.from_numpy(x)
    for axis, port_fn, ref_fn in ((1, P.split_f64, R.split_f64x), (0, P.split_f64_cols, R.split_f64x_cols)):
        np.testing.assert_array_equal(
            P.row_exponent(xt, axis).numpy(), np.asarray(R.row_exponent(fx, axis))
        )
        got_d, got_p = port_fn(xt, ns, b)
        want_d, want_p = ref_fn(fx, ns, b)
        assert got_d.dtype == torch.int8 and got_p.dtype == torch.int32
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("axis", [0, 1])
def test_split_with_external_row_exp(axis):
    """A supplied (e.g. k-shard-global) max exponent larger than the local
    one shifts every digit down, identically in both packages."""
    x = generate_input("normal01", (24, 40), seed=5)
    fx = F64X.from_numpy(x)
    e = np.asarray(R.row_exponent(fx, axis)) + 3
    got_d, got_p = P.split_with_row_exp(torch.from_numpy(x), torch.from_numpy(e), 9, 7, axis)
    want_d, want_p = R.split_with_row_exp(fx, jnp.asarray(e), 9, 7, axis)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_split_matches_pallas_kernel_interpret():
    x = generate_input("exp_rand-8", (16, 128), seed=9)
    fx = F64X.from_numpy(x)
    xt = torch.from_numpy(x)
    for axis in (0, 1):
        e = P.row_exponent(xt, axis)
        want = split_digits_pallas(fx.hi, fx.lo, jnp.asarray(e.numpy()), 9, 7, axis, 16, 128, True)
        got, _ = P.split_with_row_exp(xt, e, 9, 7, axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bit_fields_and_plane_carriage():
    x = _special().ravel()
    xt = torch.from_numpy(x)
    fx = F64X.from_numpy(x)
    from ozimmu_tpu.core import f64x

    np.testing.assert_array_equal(bits.exponent_field(xt).numpy(), np.asarray(f64x.exponent_field(fx)))
    np.testing.assert_array_equal(bits.sign_bit(xt).numpy(), np.asarray(f64x.sign_bit(fx)))
    m_hi, m_lo = f64x.mantissa_parts(fx)
    m53 = (np.asarray(m_hi).astype(np.int64) << 32) | np.asarray(m_lo).astype(np.int64)
    np.testing.assert_array_equal(bits.mantissa53(xt).numpy(), m53)
    # the two carriages convert both ways without touching a bit
    hi, lo = bits.to_f64x_planes(xt)
    np.testing.assert_array_equal(hi, np.asarray(fx.hi))
    np.testing.assert_array_equal(lo, np.asarray(fx.lo))
    back = bits.from_f64x_planes(np.asarray(fx.hi), np.asarray(fx.lo))
    np.testing.assert_array_equal(back.numpy().view(np.uint64), x.view(np.uint64))
