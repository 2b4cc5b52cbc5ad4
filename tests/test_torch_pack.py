"""The port's pack / unpack / aligned_add / scalar_triple against
ozimmu_tpu.ops.pack, bitwise, and against an exact Fraction oracle:
exact half-ulp ties, subnormal outputs, overflow to inf and -0.0."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import pack as R  # noqa: E402
from ozimmu_tpu_torch.ops import pack as P  # noqa: E402


def _u64(x):
    return np.asarray(x, dtype=np.float64).view(np.uint64)


def _pack_both(t0, t1, t2, E):
    t = [np.asarray(c, dtype=np.float32) for c in (t0, t1, t2)]
    E = np.asarray(E, dtype=np.int32)
    got = P.pack_f64(tuple(torch.from_numpy(c.copy()) for c in t), torch.from_numpy(E.copy()))
    want = R.pack_f64x(tuple(jnp.asarray(c) for c in t), jnp.asarray(E)).to_numpy()
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(_u64(got.numpy()), _u64(want))
    return got.numpy()


def _exact(t0, t1, t2, E):
    """Correctly rounded f64 of (t0+t1+t2)*2^E (int true-division is RNE)."""
    v = (Fraction(float(t0)) + Fraction(float(t1)) + Fraction(float(t2))) * Fraction(2) ** int(E)
    return float(v)


# (t0, t1, t2, E): every component f32-exact
TIES = [
    (2.0**52, 0.5, 0.0, 0),  # exact half-ulp ties -> even
    (2.0**52, 1.5, 0.0, 0),
    (2.0**52, 2.5, 0.0, 0),
    (1.0, 2.0**-53, 0.0, 0),
    (1.0, 3 * 2.0**-53, 0.0, 0),
    (2.0**52, 0.5, 2.0**-30, 0),  # sticky bits break the tie
    (2.0**52, 0.5, -(2.0**-30), 0),
    (2.0**52, -0.75, 0.0, 0),  # cancellation one binade down
    (2.0**52, -(2.0**-1), -(2.0**-26), 0),
    (2.0**53 - 2.0**29, 2.0**29 - 2.0**5, 31.5, 0),  # carry to the next binade
    (2.0**53 - 2.0**29, 2.0**29 - 2.0**5, 31.5 - 2.0**-10, 0),
    (1.5, 0.0, 0.0, -1074),  # subnormal outputs, one rounding
    (2.5, 0.0, 0.0, -1074),
    (0.5, 0.0, 0.0, -1074),
    (1.5, -(2.0**-56), 0.0, -1074),  # double-rounding trap
    (1.5, 2.0**-56, 0.0, -1074),
    (1.0, 0.0, 0.0, -1200),  # underflow to +0
    (1.0, 0.0, 0.0, -1074),
    (-(2.0**52), -1.5, 0.0, 0),  # negative ties
    (-1.5, 0.0, 0.0, -1074),
]


def test_ties_subnormals_match_reference_and_oracle():
    t0, t1, t2, E = map(list, zip(*TIES))
    got = _pack_both(t0, t1, t2, E)
    want = np.array([_exact(*row) for row in TIES])
    np.testing.assert_array_equal(_u64(got), _u64(want))


def test_overflow_to_inf_and_signed_zero():
    tail = [0.0, 0.0, 0.0, -0.0, 0.0]  # an all -0.0 triple (what unpack makes of -0.0)
    got = _pack_both([1.5, -1.5, 0.0, -0.0, 1.0], tail, tail, [1100, 1100, 0, 0, 970])
    assert np.isposinf(got[0]) and np.isneginf(got[1])
    assert _u64(got[2]) == 0 and _u64(got[3]) == 1 << 63  # +0.0 and -0.0
    assert got[4] == 2.0**970


def test_randomized_near_ties():
    rng = np.random.default_rng(7)
    n = 3000
    e0 = rng.integers(-30, 80, n)
    t0 = (rng.integers(2**23, 2**24, n) * np.exp2(e0 - 23)).astype(np.float32)
    kind = rng.integers(0, 3, n)
    t1 = np.where(
        kind == 0,
        rng.normal(size=n) * np.exp2(e0 - 24 - rng.integers(0, 8, n)),
        rng.choice([1.0, -1.0], n) * np.exp2(e0 - 53),
    ).astype(np.float32)
    t2 = np.where(
        kind == 0,
        rng.normal(size=n) * np.exp2(e0 - 48 - rng.integers(0, 8, n)),
        np.where(kind == 2, rng.choice([1.0, -1.0], n) * np.exp2(e0 - 60 - rng.integers(0, 10, n)), 0.0),
    ).astype(np.float32)
    E = rng.integers(-200, 200, n).astype(np.int32)
    got = _pack_both(t0, t1, t2, E)
    want = np.array([_exact(t0[i], t1[i], t2[i], E[i]) for i in range(n)])
    np.testing.assert_array_equal(_u64(got), _u64(want))


def test_unpack_pack_identity_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4096,)) * np.exp2(rng.integers(-320, 300, 4096))
    x[:8] = [0.0, -0.0, 2.0**-1074, -(2.0**-1074), 1.0, -1.0, np.pi, 2.0**1023]
    (p0, p1, p2), pE = P.unpack_f64(torch.from_numpy(x))
    (r0, r1, r2), rE = R.unpack_f64x(F64X.from_numpy(x))
    for g, w in ((p0, r0), (p1, r1), (p2, r2)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))
    np.testing.assert_array_equal(pE.numpy(), np.asarray(rE))
    y = P.pack_f64((p0, p1, p2), pE)
    np.testing.assert_array_equal(_u64(y.numpy()), _u64(x))


def test_aligned_add_and_scalar_triple_match_reference():
    rng = np.random.default_rng(5)
    n = 1024
    x = rng.normal(size=n) * np.exp2(rng.integers(-60, 60, n))
    y = rng.normal(size=n) * np.exp2(rng.integers(-60, 60, n))
    y[:4] = -x[:4]  # exact cancellation
    (px, pxE), (py, pyE) = P.unpack_f64(torch.from_numpy(x)), P.unpack_f64(torch.from_numpy(y))
    (rx, rxE), (ry, ryE) = R.unpack_f64x(F64X.from_numpy(x)), R.unpack_f64x(F64X.from_numpy(y))
    (ps, pE) = P.aligned_add(px, pxE, py, pyE)
    (rs, rE) = R.aligned_add(rx, rxE, ry, ryE)
    for g, w in zip(ps, rs):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))
    np.testing.assert_array_equal(pE.numpy(), np.asarray(rE))
    out = P.pack_f64(ps, pE).numpy()
    np.testing.assert_array_equal(_u64(out), _u64(R.pack_f64x(rs, rE).to_numpy()))
    for v in (1.0, -0.5, 2.0, np.pi, -1e-300, 1e300, 1.0 + 2.0**-52):
        (pt, pe), (rt, re) = P.scalar_triple(v, (3,)), R.scalar_triple(v, (3,))
        assert pe == re
        for g, w in zip(pt, rt):
            np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))
