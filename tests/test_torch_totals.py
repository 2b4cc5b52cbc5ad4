"""The int32 group totals of k panels and their fold, on the CPU, against
ozimmu_tpu: ``ops.recombine.group_totals_into`` on k-major planes padded
per panel (as the streamed distributed variants hand them to the
recombine kernel's totals mode), summed over the panels in place, equals
the JAX package's ``group_totals`` summed over the same panels, bit for
bit; ``fold_totals`` equals its ``fold_group_totals``; and the host side
of the two CUDA wrappers (the fold's launch plan, the totals mode's
plan on a panel's width, what they refuse) as plain Python."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import recombine as R  # noqa: E402
from ozimmu_tpu.ops.split import split_f64x, split_f64x_cols  # noqa: E402
from ozimmu_tpu.parallel import gemm as jpar  # noqa: E402
from ozimmu_tpu.schedule import bits_per_int8, group_schedule  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as P  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda as K  # noqa: E402
from ozimmu_tpu_torch.ops import split as S  # noqa: E402
from ozimmu_tpu_torch.parallel import gemm as tpar  # noqa: E402

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def _jax_planes(m, n, k, ns, seed):
    """The same int8 planes for both packages, from a JAX split, in the
    operands' own layout: A [ns, m, k], B [ns, k, n]."""
    b = bits_per_int8(k)
    a = generate_input("normal01", (m, k), seed=seed)
    bm = generate_input("exp_rand-8", (k, n), seed=seed + 1)
    da, _ = split_f64x(F64X.from_numpy(a), ns, b)
    db, _ = split_f64x_cols(F64X.from_numpy(bm), ns, b)
    return b, a, bm, np.array(da), np.array(db)


def _k_major_panel(da, db, off, w):
    """Columns [off, off + w) of k as the kernel reads a panel: A [ns, m,
    kp], B [ns, n, kp], zero-padded to padded_k(w)."""
    kp = P.padded_k(w)
    pa = np.zeros(da.shape[:-1] + (kp,), np.int8)
    pa[..., :w] = da[..., off:off + w]
    pb = np.zeros((db.shape[0], db.shape[2], kp), np.int8)
    pb[..., :w] = np.swapaxes(db[:, off:off + w, :], 1, 2)
    return torch.from_numpy(pa), torch.from_numpy(pb)


def _panels(k, widths):
    offs = np.cumsum([0] + list(widths))
    assert offs[-1] == k
    return list(zip(offs[:-1], widths))


def _jax_summed(da, db, ns, k, b, panels):
    """The JAX package's group totals of each panel, summed (int64, then
    checked to fit int32: the schedule's cap bounds the whole k)."""
    total = None
    for off, w in panels:
        step = R.group_totals(jnp.asarray(da[:, :, off:off + w]), jnp.asarray(db[:, off:off + w]),
                              ns, k, b)
        step = np.stack([np.asarray(x, dtype=np.int64) for x in step])
        total = step if total is None else total + step
    assert np.abs(total).max() < 2**31
    return total.astype(np.int32)


CASES = [  # m, n, k, ns, panel widths (k odd, not a multiple of 16, k = 1 among them)
    (33, 65, 47, 3, (47,)),
    (33, 65, 47, 9, (20, 27)),
    (17, 9, 130, 18, (33, 33, 64)),
    (5, 3, 1, 9, (1,)),
    (40, 24, 777, 9, (259, 259, 259)),
    (8, 8, 16384, 9, (4096,) * 4),  # the t = 10 group split into 8 + 1 pairs
]


@pytest.mark.parametrize("m,n,k,ns,widths", CASES)
def test_totals_summed_over_panels_equal_the_jax_package(m, n, k, ns, widths):
    b, _, _, da, db = _jax_planes(m, n, k, ns, seed=m + k)
    panels = _panels(k, widths)
    totals = None
    for off, w in panels:
        pa, pb = _k_major_panel(da, db, off, w)
        got = P.group_totals_into(pa, pb, ns, b, k, totals, b_kmajor=True)
        assert totals is None or got is totals  # added in place
        totals = got
    G = len(group_schedule(ns, k, b))
    assert totals.dtype == torch.int32 and tuple(totals.shape) == (G, m, n)
    want = _jax_summed(da, db, ns, k, b, panels)
    np.testing.assert_array_equal(totals.numpy(), want)
    # and folded, as the JAX package folds its summed totals
    got = P.fold_totals(totals, ns, k, b)
    ref = R.fold_group_totals([jnp.asarray(t) for t in want], ns, k, b)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(r).view(np.uint32))


@pytest.mark.parametrize("ns", [3, 9, 18])
def test_totals_of_the_ports_own_k_major_split(ns):
    """The planes straight from the port's split with ``k_pad`` (each panel
    split against the GLOBAL row and column exponents, as ``_local_split``
    does on a rank), natural-layout B through ``b_kmajor=False`` on the
    CPU, and the whole-k totals: all the same bits."""
    m, n, k = 21, 19, 99
    b, a, bm, da, db = _jax_planes(m, n, k, ns, seed=ns)
    ta, tb = torch.from_numpy(a), torch.from_numpy(bm)
    ea, eb = S.row_exponent(ta, 1), S.row_exponent(tb, 0)
    totals = None
    for off, w in _panels(k, (50, 49)):
        pa, _ = S.split_with_exp(ta[:, off:off + w], ea, ns, b, 1, P.padded_k(w))
        pb, _ = S.split_with_exp(tb[off:off + w], eb, ns, b, 0, P.padded_k(w))
        assert tuple(pb.shape) == (ns, n, P.padded_k(w))
        totals = P.group_totals_into(pa, pb, ns, b, k, totals, b_kmajor=True)
    whole = P.group_totals_into(torch.from_numpy(da), torch.from_numpy(db), ns, b, k)
    np.testing.assert_array_equal(totals.numpy(), whole.numpy())
    np.testing.assert_array_equal(totals.numpy(), _jax_summed(da, db, ns, k, b, [(0, k)]))


def test_totals_of_a_batch_equal_each_matrix():
    """[ns, B, m, kp] planes give [G, B, m, n], matrix i the JAX package's
    totals of matrix i, over two panels."""
    bsz, m, n, k, ns = 3, 9, 14, 45, 6
    mats = [_jax_planes(m, n, k, ns, seed=70 + i) for i in range(bsz)]
    b = mats[0][0]
    panels = _panels(k, (30, 15))
    totals = None
    for off, w in panels:
        parts = [_k_major_panel(da, db, off, w) for _, _, _, da, db in mats]
        pa = torch.stack([p for p, _ in parts], 1)
        pb = torch.stack([q for _, q in parts], 1)
        totals = P.group_totals_into(pa, pb, ns, b, k, totals, b_kmajor=True)
    assert tuple(totals.shape) == (len(group_schedule(ns, k, b)), bsz, m, n)
    for i, (_, _, _, da, db) in enumerate(mats):
        np.testing.assert_array_equal(totals[:, i].numpy(), _jax_summed(da, db, ns, k, b, panels))
    folded = P.fold_totals(totals, ns, k, b)
    for i in range(bsz):
        one = P.fold_totals(totals[:, i].contiguous(), ns, k, b)
        for g, o in zip(folded, one):
            np.testing.assert_array_equal(g[i].numpy().view(np.uint32), o.numpy().view(np.uint32))


@pytest.mark.parametrize("ns,k", [(3, 64), (9, 8192), (9, 16384), (18, 4096), (12, 32768)])
def test_fold_totals_equals_the_jax_fold_at_the_extremes(ns, k):
    """Totals over the whole int32 range, INT32_MIN and +-(2^31 - 1) among
    them (the hi / lo split at its ends): the plain fold == the JAX
    package's, bit for bit."""
    b = bits_per_int8(k)
    G = len(group_schedule(ns, k, b))
    rng = np.random.default_rng(ns + k)
    t = rng.integers(INT32_MIN, INT32_MAX, size=(G, 6, 11), dtype=np.int64, endpoint=True)
    t[:, 0, :4] = [INT32_MIN, INT32_MAX, -INT32_MAX, 0]
    t[:, 1, :] = rng.integers(-70000, 70000, size=(G, 11))
    t[:, 2, :] = INT32_MIN
    t = t.astype(np.int32)
    got = P.fold_totals(torch.from_numpy(t), ns, k, b)
    want = R.fold_group_totals([jnp.asarray(x) for x in t], ns, k, b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("elems", [1, 3, 4, 17, 1000, 8192 * 8192, 3 * 1000 * 777])
def test_fold_plan(elems, sms):
    for aligned in (False, True):
        p = K.fold_plan(elems, sms, aligned)
        assert p.vec == (4 if aligned and elems % 4 == 0 else 1)
        assert p.threads == K.FOLD_THREADS == 256
        assert 1 <= p.grid <= sms * K.FOLD_BLOCKS_PER_SM
        # the grid-stride loop covers every element: units of vec, a thread each
        assert elems % p.vec == 0 and p.grid * p.threads >= min(elems // p.vec,
                                                                 sms * K.FOLD_BLOCKS_PER_SM * 256)
    with pytest.raises(ValueError):
        K.fold_plan(0, sms, True)


@pytest.mark.parametrize("w", [1, 15, 16, 17, 1024, 2048, 4097])
def test_totals_mode_plans_from_the_panels_width(w):
    """The totals mode's launch takes the k tiles from the panel's own
    k_pad (a multiple of 16) and the schedule from the global k: the plan
    of a panel keeps its k_pad, whatever the contraction."""
    kp = P.padded_k(w)
    for m, n in ((8192, 8192), (17, 9), (2048, 2048)):
        plan = K.launch_plan(m, n, kp, 9, 132)
        assert plan.k_pad == kp
    n_groups, start, pi, pj, shi, slo = K._schedule_arrays(9, 65536, 7)
    assert n_groups == len(group_schedule(9, 65536, 7)) == 25
    assert start[-1] == len(pi) == len(pj) == 45


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers take CUDA tensors only; they raise, with nothing
    copied, before any kernel is built."""
    ns, k, b = 3, 32, 7
    da = torch.zeros((ns, 4, 32), dtype=torch.int8)
    db = torch.zeros((ns, 5, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        K.group_totals(da, db, ns, b, k)
    G = len(group_schedule(ns, k, b))
    with pytest.raises(ValueError, match="CUDA"):
        K.fold_totals(torch.zeros((G, 4, 5), dtype=torch.int32), ns, k, b)
    with pytest.raises(ValueError, match="unsupported device"):
        P.fold_totals(torch.zeros((G, 4, 5), dtype=torch.int32, device="meta"), ns, k, b)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_k_model_counts_planes_and_totals(p):
    """The port's k model: the JAX package's k test (operand blocks and
    the output term) plus the split planes and the int32 group totals,
    4 B a group over the full block and, over several ranks, its
    scattered rows; never below the JAX package's count."""
    for m, n, k, ns in ((8192, 8192, 8192, 9), (2048, 2048, 65536, 9), (256, 256, 4096, 9),
                        (100, 30, 1000, 14)):
        G = len(group_schedule(ns, k, bits_per_int8(k)))
        kl = -(-k // p)
        totals = 4 * G * m * n
        want = ((ns + 8) * (m + n) * kl + totals + (totals // p if p > 1 else 0)
                + 28 * m * n)
        assert tpar.k_device_bytes(m, n, k, ns, p) == want
        assert tpar.k_device_bytes(m, n, k, ns, p, True) == 2 * want
        jax_k = 28 * m * n + 8 * (m + n) * kl
        assert want > jax_k
    # the tall Gram product the chooser sends to "k" on one card
    assert tpar.select_variant(2048, 2048, 65536, 9, _OneRank(), hbm_bytes=6 << 30) == "k"
    # where the planes and totals do not fit but summa's slabs do, the JAX
    # package's test still says "k"
    budget = (4 << 30) + (700 << 20)
    assert jpar.select_variant(2048, 2048, 65536, 9, _JaxOneRank(), hbm_bytes=budget) == "k"
    assert tpar.select_variant(2048, 2048, 65536, 9, _OneRank(), hbm_bytes=budget) == "summa"


class _OneRank:
    device_type = "cpu"
    mesh_dim_names = ("x", "y")

    def size(self, dim):
        return 1


class _JaxOneRank:
    shape = {"x": 1, "y": 1}
