"""The recombine kernel's host side on the CPU: the zero padding of k that
its tensor maps need, and its launch plan (tile class, padded k, grid,
shared memory).  The padding is checked through the plain version, which
is what the kernel must equal bitwise on the card."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import recombine as R  # noqa: E402
from ozimmu_tpu.ops.split import split_f64x, split_f64x_cols  # noqa: E402
from ozimmu_tpu.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as P  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda as K  # noqa: E402


def _eq_triple(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("ns", [3, 9, 18])
@pytest.mark.parametrize("k", [777, 1000, 1025])
def test_zero_padded_k_is_exact(k, ns):
    """Planes zero-padded along k to the kernel's multiple (the wrapper's
    own helper), with the schedule on the true k, recombine to the same
    bits as the unpadded planes, and as ozimmu_tpu's XLA recombine."""
    m, n = 9, 7
    b = bits_per_int8(k)
    a = generate_input("normal01", (m, k), seed=k + ns)
    bm = generate_input("exp_rand-8", (k, n), seed=k + ns + 1)
    da, _ = split_f64x(F64X.from_numpy(a), ns, b)
    db, _ = split_f64x_cols(F64X.from_numpy(bm), ns, b)
    da, db = np.array(da), np.array(db)
    tda, tdb = torch.from_numpy(da), torch.from_numpy(db)
    plan = K.launch_plan(m, n, k, ns, sms=132)
    pa = K._pad_k_major(tda, plan.k_pad)
    pb = K._pad_k_major(tdb.transpose(1, 2), plan.k_pad).transpose(1, 2)
    assert pa.shape == (ns, m, plan.k_pad) and pb.shape == (ns, plan.k_pad, n)
    assert plan.k_pad > k and not pa[:, :, k:].any() and not pb[:, k:, :].any()
    padded = P.fold_group_totals(P.group_totals(pa, pb, ns, k, b), ns, k, b)
    plain = P.fold_group_totals(P.group_totals(tda, tdb, ns, k, b), ns, k, b)
    _eq_triple(padded, plain)
    _eq_triple(padded, R.recombine(jnp.asarray(da), jnp.asarray(db), ns, b, k))


@pytest.mark.parametrize(
    "m,n,tile",
    [(8192, 8192, 0), (4096, 4096, 0), (2048, 2048, 0), (1025, 1023, 0),
     (1024, 1024, 1), (1023, 1023, 1), (17, 9, 1), (130, 260, 1), (512, 640, 1)],
)
def test_launch_plan_tile_class(m, n, tile):
    """On an H100 (132 SMs) the 128x256 cluster class takes the products
    that fill the card, the 64x128 class those it would leave mostly idle."""
    plan = K.launch_plan(m, n, 1024, 9, sms=132)
    assert plan.tile == tile
    nc, bn, stages, cm = K.TILES[tile]
    assert (plan.block_m, plan.block_n, plan.stages, plan.cluster) == (64 * nc, bn, stages, cm)
    units = math.ceil(math.ceil(m / plan.block_m) / cm) * math.ceil(n / bn)
    assert plan.tiles == units * cm
    assert plan.grid == cm * min(132 // cm, units)


@pytest.mark.parametrize("sms", [1, 2, 7, 132])
@pytest.mark.parametrize("ns", [3, 9, 16, 18])
def test_launch_plan_limits(sms, ns):
    for m, n, k in [(1, 1, 1), (17, 9, 32), (1025, 1023, 1025), (8192, 8192, 8192),
                    (130, 260, 4096), (512, 640, 32768), (3, 70000, 777)]:
        for tile in [None, *range(len(K.TILES))]:
            if tile is not None and K.TILES[tile][3] > sms:
                with pytest.raises(ValueError, match="SMs"):
                    K.launch_plan(m, n, k, ns, sms, tile)
                continue
            p = K.launch_plan(m, n, k, ns, sms, tile)
            assert 1 <= p.grid <= sms and p.grid <= p.tiles and p.grid % p.cluster == 0
            assert p.k_pad % K.K_ALIGN == 0 and k <= p.k_pad < k + K.K_ALIGN
            assert p.smem_bytes <= K.SMEM_LIMIT
            assert p.pairs == ns * (ns + 1) // 2 <= K.MAX_PAIRS


def test_launch_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 64, 19, 132)  # 190 pairs > 171
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 0, 9, 132)
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 64, 9, 0)
