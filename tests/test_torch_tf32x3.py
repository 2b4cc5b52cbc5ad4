"""ozimmu_tpu_torch.ops.tf32x3 against ozimmu_tpu.ops.tf32x3, bitwise, on
random and adversarial float32 inputs.

Magnitudes stay where every intermediate is an f32 NORMAL number: XLA:CPU
flushes f32 subnormals and PyTorch does not, which is a difference of the
two runtimes, not of the algorithms (the engine keeps its accumulator in
the normal range by construction, ops/recombine.py ACC_SHIFT)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.ops import tf32x3 as R  # noqa: E402
from ozimmu_tpu_torch.ops import tf32x3 as P  # noqa: E402


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _eq(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _random(seed, n=4096, lo=-20, hi=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * np.exp2(rng.integers(lo, hi, n))
    return x.astype(np.float32)


def _adversarial():
    """Pairs (a, b) that exercise ties, cancellation, signed zeros and
    magnitude gaps."""
    one = np.float32(1.0)
    eps = np.float32(2.0**-24)
    a = [1.0, 1.0, 1.0, -1.0, 2.0**24, 2.0**24, 3.0, 0.0, -0.0, 0.0, 1.5, 2.0**20, 1.0 + 2.0**-23,
         2.0**-20, -(2.0**20), 4097.0, 1.0 / 3.0, 2.0**12 + 1.0]
    b = [eps, -eps, 3 * eps, eps, 1.0, -1.0, -3.0, -0.0, -0.0, 0.0, -1.5 + 2.0**-22,
         -(2.0**20) + 2.0**-3, -one, 2.0**-44, 2.0**-4, 4097.0, -1.0 / 3.0, 2.0**12 - 1.0]
    return np.array(a, dtype=np.float32), np.array(b, dtype=np.float32)


def _inputs():
    a_adv, b_adv = _adversarial()
    a = np.concatenate([_random(1), a_adv])
    b = np.concatenate([_random(2), b_adv])
    return a, b


def _triple(seed, n=2048):
    """Renormalized random triples with magnitudes in [2^-20, 2^20]."""
    rng = np.random.default_rng(seed)
    t0 = _random(seed, n)
    t1 = (t0 * np.float32(2.0**-24) * rng.uniform(-1, 1, n).astype(np.float32)).astype(np.float32)
    t2 = (t1 * np.float32(2.0**-24) * rng.uniform(-1, 1, n).astype(np.float32)).astype(np.float32)
    return t0, t1, t2


def _both(t):
    return tuple(torch.from_numpy(c.copy()) for c in t), tuple(jnp.asarray(c) for c in t)


@pytest.mark.parametrize("fn", ["two_sum", "quick_two_sum", "two_prod"])
def test_binary_primitives(fn):
    a, b = _inputs()
    if fn == "quick_two_sum":  # requires |a| >= |b|
        swap = np.abs(a) < np.abs(b)
        a, b = np.where(swap, b, a), np.where(swap, a, b)
    got = getattr(P, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = getattr(R, fn)(jnp.asarray(a), jnp.asarray(b))
    _eq(got, want)


def test_f32_split():
    a, _ = _inputs()
    _eq(P.f32_split(torch.from_numpy(a)), R.f32_split(jnp.asarray(a)))


def test_renorm_add_term_add_mul():
    tp, tj = _both(_triple(3))
    up, uj = _both(_triple(4))
    x = _random(5, 2048)
    _eq(P.renorm(tp), R.renorm(tj))
    _eq(P.add_term(tp, torch.from_numpy(x)), R.add_term(tj, jnp.asarray(x)))
    _eq(P.add(tp, up), R.add(tj, uj))
    _eq(P.mul(tp, up), R.mul(tj, uj))
    # full cancellation x + (-x), and a product with zero
    neg_p = tuple(-c for c in tp)
    neg_j = tuple(-c for c in tj)
    _eq(P.add(tp, neg_p), R.add(tj, neg_j))
    _eq(P.mul(tp, P.zeros(2048)), R.mul(tj, R.zeros(2048)))


def test_pow2_and_scale_pow2():
    e = np.arange(-126, 128, dtype=np.int32)
    _eq(P.pow2_f32(torch.from_numpy(e)), R.pow2_f32(jnp.asarray(e)))
    tp, tj = _both(_triple(6, n=512))
    rng = np.random.default_rng(7)
    ee = rng.integers(-30, 30, 512).astype(np.int32)  # results stay normal
    _eq(P.scale_pow2(tp, torch.from_numpy(ee)), R.scale_pow2(tj, jnp.asarray(ee)))
    _eq(P.scale_pow2(tp, 5), R.scale_pow2(tj, 5))


def test_from_f64_host():
    rng = np.random.default_rng(8)
    vals = [0.0, -0.0, 1.0, -2.5, np.pi, 1e300, -1e-300, 5e-324, 2.0**-1022, 1.0 + 2.0**-52]
    vals += list(rng.normal(size=50) * np.exp2(rng.integers(-500, 500, 50)))
    for v in vals:
        assert P.from_f64_host(float(v)) == R.from_f64_host(float(v))
    for bad in (float("inf"), float("nan")):
        with pytest.raises(ValueError):
            P.from_f64_host(bad)
