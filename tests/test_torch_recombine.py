"""The port's recombination (plain PyTorch version, CPU) against
ozimmu_tpu's: int32 group totals and the triple-f32 accumulator, bitwise —
plus one small case against the Pallas kernel itself in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import recombine as R  # noqa: E402
from ozimmu_tpu.ops.recombine_pallas import recombine_pallas  # noqa: E402
from ozimmu_tpu.ops.split import split_f64x, split_f64x_cols  # noqa: E402
from ozimmu_tpu.schedule import bits_per_int8, group_schedule  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as P  # noqa: E402


def _digits(m, n, k, ns, seed):
    """The same int8 planes for both packages, from a JAX split."""
    b = bits_per_int8(k)
    a = generate_input("normal01", (m, k), seed=seed)
    bm = generate_input("exp_rand-8", (k, n), seed=seed + 1)
    da, _ = split_f64x(F64X.from_numpy(a), ns, b)
    db, _ = split_f64x_cols(F64X.from_numpy(bm), ns, b)
    da, db = np.array(da), np.array(db)
    return b, da, db, torch.from_numpy(da), torch.from_numpy(db)


def _eq_triple(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize(
    "m,n,k,ns",
    [(33, 65, 47, 3), (33, 65, 47, 9), (17, 9, 130, 12), (5, 3, 1, 18), (8, 8, 16384, 9)],
)
def test_group_totals_and_fold_match_reference(m, n, k, ns):
    b, da, db, tda, tdb = _digits(m, n, k, ns, seed=m + k)
    got = P.group_totals(tda, tdb, ns, k, b)
    want = R.group_totals(jnp.asarray(da), jnp.asarray(db), ns, k, b)
    assert len(got) == len(want) == len(group_schedule(ns, k, b))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _eq_triple(P.fold_group_totals(got, ns, k, b), R.fold_group_totals(want, ns, k, b))
    # the device dispatch on a CPU tensor is the same plain composition
    _eq_triple(P.recombine(tda, tdb, ns, b, k), R.recombine(jnp.asarray(da), jnp.asarray(db), ns, b, k))


def test_group_splits_at_its_cap():
    """At k = 16384, b = 7 a group holds at most 8 pairs: the t = 10 group
    of ns = 9 (9 pairs) splits into 8 + 1, in both packages."""
    assert [len(g.pairs) for g in group_schedule(9, 16384, 7)] == [1, 2, 3, 4, 5, 6, 7, 8, 8, 1]


def test_int_mm_padding_is_exact():
    rng = np.random.default_rng(4)
    for m, k, n in [(1, 1, 1), (16, 8, 8), (17, 9, 7), (33, 65, 47)]:
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (k, n), dtype=np.int8)
        got = P._int_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_recombine_matches_pallas_kernel_interpret():
    m, n, k, ns = 64, 128, 256, 4
    b, da, db, tda, tdb = _digits(m, n, k, ns, seed=3)
    want = recombine_pallas(jnp.asarray(da), jnp.asarray(db), ns, b, k, 128, 128, 128, True)
    _eq_triple(P.recombine(tda, tdb, ns, b, k), want)
