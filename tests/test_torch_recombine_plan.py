"""The recombine kernel's host side on the CPU: the zero padding of k that
its tensor maps need, and its launch plan (tile class, padded k, grid,
shared memory).  The padding is checked through the plain version, which
is what the kernel must equal bitwise on the card."""

import dataclasses
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
from ozimmu_tpu_torch.schedule import group_schedule  # noqa: E402
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
    "m,n,k,tile",
    [(8192, 8192, 1024, 2), (4096, 4096, 1024, 2), (2048, 2048, 1024, 2), (1025, 1023, 1024, 2),
     (1024, 1024, 1024, 2), (1023, 1023, 1024, 2), (17, 9, 1024, 2), (130, 260, 1024, 2),
     (512, 640, 1024, 2),
     (8192, 8192, 16384, 0), (4096, 4096, 16384, 0), (2048, 2048, 16384, 0),
     (1025, 1023, 16384, 2), (1024, 1024, 16384, 1), (1023, 1023, 16384, 1), (17, 9, 16384, 1),
     (130, 260, 16384, 1), (512, 640, 16384, 1), (8192, 8192, 4096, 0), (16384, 16384, 8192, 0)],
)
def test_launch_plan_tile_class(m, n, k, tile):
    """On an H100 (132 SMs) the kept class takes every product at k =
    1024 (its triple never makes the round trip through the output planes
    that costs the other classes as much as their int8 work there); at long
    k the 128x256 cluster class takes the products that fill the card, the
    64x128 class those it would leave mostly idle, and the kept class those
    whose few tiles only its 2x2 clusters spread over most SMs."""
    plan = K.launch_plan(m, n, k, 9, sms=132)
    assert plan.tile == tile
    nc, bn, stages, cm, cn = K.TILES[tile]
    assert (plan.block_m, plan.block_n, plan.stages, plan.cluster) == (64 * nc, bn, stages,
                                                                        cm * cn)
    units = math.ceil(math.ceil(m / plan.block_m) / cm) * math.ceil(math.ceil(n / bn) / cn)
    assert plan.tiles == units * cm * cn
    assert plan.grid == cm * cn * min(132 // (cm * cn), units)


@pytest.mark.parametrize("sms", [1, 2, 7, 132])
@pytest.mark.parametrize("ns", [3, 9, 16, 18])
def test_launch_plan_limits(sms, ns):
    for m, n, k in [(1, 1, 1), (17, 9, 32), (1025, 1023, 1025), (8192, 8192, 8192),
                    (130, 260, 4096), (512, 640, 32768), (3, 70000, 777)]:
        for totals in (False, True):
            classes = K.TOTALS_TILES if totals else range(len(K.TILES))
            for tile in [None, *classes]:
                if tile is not None and K.TILES[tile][3] * K.TILES[tile][4] > sms:
                    with pytest.raises(ValueError, match="SMs"):
                        K.launch_plan(m, n, k, ns, sms, tile, totals=totals)
                    continue
                p = K.launch_plan(m, n, k, ns, sms, tile, totals=totals)
                assert p.tile in classes
                assert 1 <= p.grid <= sms and p.grid <= p.tiles and p.grid % p.cluster == 0
                assert p.k_pad % K.K_ALIGN == 0 and k <= p.k_pad < k + K.K_ALIGN
                assert p.smem_bytes <= K.SMEM_LIMIT
                assert p.pairs == ns * (ns + 1) // 2 <= K.MAX_PAIRS


@pytest.mark.parametrize("ns", [3, 9, 18])
@pytest.mark.parametrize("m,n", [(44032, 44032), (1024, 44032), (16384, 16384), (8192, 8192),
                                 (4096, 4096), (2048, 2048)])
def test_launch_plan_keeps_the_triple_at_short_k(m, n, ns):
    """Products that fill the card take the kept class at short k (HPL's
    two updates of a step with NB = 1024 among them) and the 128x256 class
    from a crossover on: one k, at which the large class's int8 work at
    its higher rate outweighs its triple's round trips, beyond which it
    keeps the large class for every longer k."""
    groups = lambda k: len(group_schedule(ns, k))  # noqa: E731
    for k in (256, 1000, 1024):
        assert K.launch_plan(m, n, k, ns, sms=132, groups=groups(k)).tile == K.KEPT_TILE, k
    chosen = [K.launch_plan(m, n, k, ns, sms=132, groups=groups(k)).tile
              for k in range(1024, 65537, 512)]
    crossover = chosen.index(0)
    assert set(chosen[:crossover]) == {K.KEPT_TILE} and set(chosen[crossover:]) == {0}
    # at ns = 9 it lies between the H100's timings at k = 2048 (kept 0.62 of the large
    # class's time at 16384^2) and k = 4096 (1.03 on the batch 4 x 4096^3)
    if ns == 9:
        assert 2048 < 1024 + 512 * crossover <= 4096


@pytest.mark.parametrize("m,n,k", [(44032, 44032, 1024), (1024, 44032, 1024), (17, 9, 32),
                                   (1025, 1023, 1025), (2048, 65536, 2048), (130, 260, 16)])
def test_launch_plan_never_keeps_in_the_totals_mode(m, n, k):
    """The totals mode has no triple to keep: it chooses among the classes
    it had, as it did (the int8 work alone), and refuses the kept class
    when forced."""
    for ns in (3, 9, 18):
        plan = K.launch_plan(m, n, k, ns, sms=132, totals=True)
        assert plan.tile in K.TOTALS_TILES

        def work(t):  # the totals mode's weighing: waves x tile area / rate
            nc, bn, _, cm, cn = K.TILES[t]
            units = math.ceil(math.ceil(m / (64 * nc)) / cm) * math.ceil(math.ceil(n / bn) / cn)
            return math.ceil(units / (132 // (cm * cn))) * 64 * nc * bn / K.TILE_RATE[t]

        assert plan.tile == min(K.TOTALS_TILES, key=work)
        with pytest.raises(ValueError, match="no totals mode"):
            K.launch_plan(m, n, k, ns, sms=132, tile=K.KEPT_TILE, totals=True)


def test_launch_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 64, 19, 132)  # 190 pairs > 171
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 0, 9, 132)
    with pytest.raises(ValueError):
        K.launch_plan(64, 64, 64, 9, 0)


#: an 80 GB H100's L2 (torch's ``L2_cache_size``)
H100_L2 = 50 * 2**20


@pytest.mark.parametrize("m,n,k,ns,batch,tile,totals,engaged", [
    (16384, 16384, 16384, 9, 1, None, False, True),   # the headline: 75.5 MB of planes a unit
    (16384, 16384, 16384, 9, 1, None, True, True),    # the totals mode takes the same rule
    (16384, 16384, 16384, 12, 1, None, False, True),  # 101 MB, 78 pairs
    (16384, 16384, 32768, 9, 1, None, False, True),   # 151 MB
    (32768, 8192, 16384, 9, 1, None, False, True),    # 75.5 MB, 4096 units
    (16384, 16384, 8192, 9, 1, None, False, True),    # 37.7 MB: over half the L2
    (24576, 24576, 8192, 9, 1, None, False, True),    # 37.7 MB, 140 waves
    (16384, 16384, 8192, 12, 1, None, False, True),   # 50.3 MB, 78 pairs
    (16384, 16384, 16384, 15, 1, None, False, False),  # 126 MB, but 120 pairs
    (8192, 8192, 8192, 18, 1, None, False, False),    # 75.5 MB, but 15.5 waves and 171 pairs
    (16384, 16384, 8192, 18, 1, None, False, False),  # 75.5 MB and 62 waves, but 171 pairs
    (8192, 8192, 16384, 9, 1, None, False, False),    # 75.5 MB, but 15.5 waves
    (12288, 12288, 12288, 9, 1, None, False, False),  # 56.6 MB, but 35 waves
    (8192, 8192, 8192, 9, 1, None, False, False),     # 37.7 MB; the ZGEMM cell's four passes
    (4096, 4096, 4096, 9, 4, None, False, False),     # 18.9 MB, the batch cell
    (16384, 16384, 4096, 9, 1, None, False, False),   # 18.9 MB: under half the L2
    (44032, 44032, 1024, 9, 1, None, False, False),   # HPL's update: the kept class
    (1024, 44032, 1024, 9, 1, None, False, False),    # HPL's U12 product
    (1024, 1024, 1024, 9, 1, None, False, False),     # the intercepted call
    (16384, 16384, 1024, 18, 1, 0, False, False),     # class 0 forced at k = 1024: 18.9 MB
    (16384, 16384, 16384, 9, 1, 1, False, False),     # the classes without the walk,
    (16384, 16384, 16384, 9, 1, 2, False, False),     # even where a unit exceeds the L2
    (1025, 1023, 16384, 9, 1, None, False, False),    # the kept class's few tiles at long k
    (200, 200, 65536, 18, 1, 0, False, False),        # one cluster, one unit
])
def test_lockstep_engages_where_the_free_walk_drifts(m, n, k, ns, batch, tile, totals, engaged):
    """The bounded-skew walk engages exactly where one cluster unit's own
    plane bytes, ns * k_pad * (256 + 256) in class 0, exceed half the
    card's L2, each cluster walks at least MIN_WAVES units and the schedule has at
    most WALK_MAX_PAIRS pairs (where an H100 measured the walk to win), in
    class 0 only; without an L2 size it never does.  Engaged or not, the
    plan is otherwise the one it was."""
    plan = K.launch_plan(m, n, k, ns, sms=132, tile=tile, batch=batch, totals=totals,
                         l2_bytes=H100_L2)
    free = K.launch_plan(m, n, k, ns, sms=132, tile=tile, batch=batch, totals=totals)
    assert free.window == 0
    assert (plan.window > 0) == engaged
    assert dataclasses.replace(plan, window=0) == free
    if engaged:
        assert plan.tile in K.WALK_TILES and plan.pairs <= K.WALK_MAX_PAIRS
        assert plan.tiles // plan.cluster >= K.MIN_WAVES * (plan.grid // plan.cluster)
        assert 2 * ns * plan.k_pad * (plan.block_m * 2 + plan.block_n) > H100_L2
        assert plan.window == K.lockstep_window(H100_L2, plan, m, n)
    if (m, n, k, ns, batch, tile, totals) == (16384, 16384, 16384, 9, 1, None, False):
        # 66 clusters over 8 cluster rows and 9 columns: 544 KiB of tiles a step
        assert plan.window == int(K.WINDOW_SHARE * H100_L2 / 557_056) == 282


@pytest.mark.parametrize("l2", [1, 2**20, 2**23, H100_L2, 2**40])
@pytest.mark.parametrize("m,n,k,ns,batch", [
    (16384, 16384, 16384, 9, 1), (8192, 8192, 8192, 18, 1), (1792, 2560, 2048, 9, 1),
    (300, 520, 2000, 3, 3), (65536, 512, 777, 16, 1),
])
def test_lockstep_window_is_bounded_and_grows_with_the_l2(l2, m, n, k, ns, batch):
    """The window is a pure function of the L2 size, the class and the band
    of clusters in flight: at least 1 step, at most one unit's steps (pairs
    x k tiles), and never smaller for a larger L2."""
    plan = K.launch_plan(m, n, k, ns, sms=132, tile=0, batch=batch)
    steps = plan.pairs * math.ceil(plan.k_pad / K.BLOCK_K)
    w = K.lockstep_window(l2, plan, m, n)
    assert 1 <= w <= steps and w == K.lockstep_window(l2, plan, m, n)
    assert K.lockstep_window(2 * l2, plan, m, n) >= w
    if l2 == 2**40:
        assert w == steps
