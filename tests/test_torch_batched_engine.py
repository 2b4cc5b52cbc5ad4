"""The batched engine (``core.gemm.gemm_f64_batched`` /
``zgemm_f64_batched``): one split per operand and one recombination for a
whole batch, as the JAX package's ``vmap`` runs it.

Bitwise throughout (uint64 views): the batched plain split and
recombination against their 2-D forms matrix by matrix; ``gemm_batched``
against ``ozimmu_tpu.gemm_batched``; ``traced.gemm_batched`` compiled
against eager and against ``jax.jit`` of ``ozimmu_tpu.traced``; an
intercepted ``einsum`` and ``baddbmm`` against ``gemm_batched``;
sub-batches against one batch; and the calls of the split and the
recombination per batch, whatever its size.  CPU tensors, small shapes."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu.traced as jtraced  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
import ozimmu_tpu_torch.intercept as ozi  # noqa: E402
from ozimmu_tpu_torch import traced  # noqa: E402
from ozimmu_tpu_torch.core import gemm as engine  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as rec  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda  # noqa: E402
from ozimmu_tpu_torch.ops import split  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

SHAPES = {"33x17x70": (33, 17, 70), "1x40x9": (1, 40, 9)}  # m x k x n


def _u64(x):
    if isinstance(x, torch.Tensor):
        x = torch.view_as_real(x) if x.is_complex() else x
        x = x.numpy()
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], axis=-1)
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _same(got, want):
    np.testing.assert_array_equal(_u64(got), _u64(want))


def _cpu():
    return ozt.create(device="cpu")


def _batch(kind, bsz, m, k, n, seed, dist="normal01", b_dist="exp_rand-8"):
    cx = kind == "complex"
    a = generate_input(dist, (bsz, m, k), seed=seed, complex_=cx)
    b = generate_input(b_dist, (bsz, k, n), seed=seed + 1, complex_=cx)
    c = generate_input("normal01", (bsz, m, n), seed=seed + 2, complex_=cx)
    return a, b, c


def _special_batch():
    """exp_rand-8 data, a zero row (matrix 0), a zero column (matrix 1) and
    subnormals (matrix 2), [3, 9, 13]."""
    x = generate_input("exp_rand-8", (3, 9, 13), seed=7)
    x[0, 4, :] = 0.0
    x[1, :, 5] = 0.0
    x[2, 3, 3] = 5e-324
    x[2, 6, 1] = -1e-310
    return torch.from_numpy(x)


@pytest.mark.parametrize("ns", [3, 9, 18])
@pytest.mark.parametrize("axis", [1, 0])
def test_plain_split_of_a_batch_is_the_2d_split_of_each_matrix(ns, axis):
    """A by rows (axis 1) and B by columns (axis 0)."""
    x = _special_batch()
    b = bits_per_int8(x.shape[1 + axis])
    f = split.split_f64 if axis == 1 else split.split_f64_cols
    digits, pexp = f(x, ns, b)
    assert tuple(digits.shape) == (ns, *x.shape)
    assert tuple(pexp.shape) == (x.shape[0], x.shape[2 - axis])
    for i in range(x.shape[0]):
        d2, p2 = f(x[i], ns, b)
        assert torch.equal(digits[:, i], d2), i
        assert torch.equal(pexp[i], p2), i
    # the zero row and column split to zero digits and the sentinel scale
    assert int(pexp.min()) == split.ZERO_ROW_PEXP


@pytest.mark.parametrize("ns", [3, 9, 18])
def test_plain_recombine_of_a_batch_is_the_2d_recombine_of_each_matrix(ns):
    bsz, m, k, n = 3, 11, 37, 7
    a, b, _ = _batch("real", bsz, m, k, n, seed=ns)
    bb = bits_per_int8(k)
    da, _ = split.split_f64(torch.from_numpy(a), ns, bb)
    db, _ = split.split_f64_cols(torch.from_numpy(b), ns, bb)
    got = rec.recombine(da, db, ns, bb, k)
    totals = rec.group_totals(da, db, ns, k, bb)
    assert all(tuple(t.shape) == (bsz, m, n) for t in totals)
    for i in range(bsz):
        want = rec.fold_group_totals(rec.group_totals(da[:, i], db[:, i], ns, k, bb), ns, k, bb)
        for g, w in zip(got, want):
            assert torch.equal(g[i].view(torch.int32), w.view(torch.int32)), i


@pytest.mark.parametrize("bsz,ns", [(1, 3), (3, 9), (5, 18)])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("with_c", [False, True])
def test_gemm_batched_bits_match_the_jax_package(kind, shape, bsz, ns, with_c):
    m, k, n = SHAPES[shape]
    a, b, c = _batch(kind, bsz, m, k, n, seed=10 * bsz + ns)
    alpha, beta = (1.5 - 0.5j, 0.5 + 0.25j) if kind == "complex" else (1.5, -0.5)
    kw = dict(mode=f"fp64_int8_{ns}", alpha=alpha, beta=beta if with_c else 0.0,
              c=c if with_c else None)
    got = ozt.gemm_batched(a, b, handle=_cpu(), **kw)
    assert got.shape == (bsz, m, n)
    _same(got, oz.gemm_batched(a, b, **kw))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_auto_batched_odd_shape_matches_the_jax_package(kind):
    """Operands for which AUTO picks an int8 mode (exp_rand-8 ones fall
    back to dgemm, which is held to a bound, not to bits)."""
    a, b, c = _batch(kind, 5, *SHAPES["33x17x70"], seed=60, dist="urand01", b_dist="urand01")
    h, hr = _cpu(), oz.create()
    _same(ozt.gemm_batched(a, b, c=c, beta=2.0, handle=h),
          oz.gemm_batched(a, b, c=c, beta=2.0, handle=hr))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_compiled_traced_batch_equals_eager_and_jax_jit(kind):
    cx = kind == "complex"
    a, b, c = _batch(kind, 3, *SHAPES["33x17x70"], seed=70)
    kw = dict(num_split=12, alpha=2.0 - 1j if cx else 2.0, beta=0.5 + 0.5j if cx else 0.5)
    want = jax.jit(lambda x, y, z: jtraced.gemm_batched(x, y, c=z, **kw))(a, b, c)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    fn = lambda x, y, z: traced.gemm_batched(x, y, c=z, **kw)  # noqa: E731
    got = torch.compile(fn, backend="aot_eager", fullgraph=True)(ta, tb, tc)
    _same(got, fn(ta, tb, tc))
    _same(got, np.asarray(want))


def test_intercepted_einsum_and_baddbmm_equal_gemm_batched():
    a, b, c = _batch("real", 3, 40, 48, 24, seed=80)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    h = _cpu()
    h.intercept_threshold_m = h.intercept_threshold_n = h.intercept_threshold_k = 16
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got_e = torch.einsum("bik,bkj->bij", ta, tb)
        got_b = torch.baddbmm(tc, ta, tb, beta=0.5, alpha=2.0)
    want = ozt.gemm_batched(ta, tb, mode="fp64_int8_9")
    _same(got_e, want)
    _same(got_b, want * 2.0 + tc * 0.5)


def _count_calls(monkeypatch):
    """Calls of the plain split and of the plain recombination (the CPU
    stand-ins of the two kernels' launches)."""
    calls = {"split": 0, "recombine": 0}

    def counted(name, fn):
        def f(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return f

    monkeypatch.setattr(split, "split_with_row_exp", counted("split", split.split_with_row_exp))
    monkeypatch.setattr(rec, "fold_group_totals", counted("recombine", rec.fold_group_totals))
    return calls


@pytest.mark.parametrize("bsz", [1, 3, 5])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_one_split_per_operand_and_one_recombine_per_batch(monkeypatch, kind, bsz):
    a, b, c = _batch(kind, bsz, *SHAPES["33x17x70"], seed=90)
    calls = _count_calls(monkeypatch)
    ozt.gemm_batched(a, b, c=c, beta=1.0, mode="fp64_int8_9", handle=_cpu())
    assert calls == ({"split": 4, "recombine": 4} if kind == "complex"
                     else {"split": 2, "recombine": 1})


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sub_batches_equal_one_batch(monkeypatch, kind):
    """Without ``OZIMMU_HBM_BUDGET_MB`` the budget is the host's: one
    batch.  Under 1 MiB a 33 x 60 x 70 product's working set and epilogue
    fit at most once: a sub-batch per matrix."""
    a, b, c = (torch.from_numpy(x) for x in _batch(kind, 5, 33, 60, 70, seed=100))
    kw = dict(mode="fp64_int8_9", alpha=0.75, beta=-2.0, c=c, handle=_cpu())
    whole = ozt.gemm_batched(a, b, **kw)
    assert len(engine._sub_batches(5, 33, 70, 60, 9, kind == "complex", "cpu")) == 1
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "1")
    parts = engine._sub_batches(5, 33, 70, 60, 9, kind == "complex", "cpu")
    assert 2 <= len(parts) <= 5 and [i for s in parts for i in range(5)[s]] == list(range(5))
    calls = _count_calls(monkeypatch)
    _same(ozt.gemm_batched(a, b, **kw), whole)
    per = (4, 4) if kind == "complex" else (2, 1)
    assert calls == {"split": per[0] * len(parts), "recombine": per[1] * len(parts)}


def test_a_matrix_that_needs_column_panels_runs_matrix_by_matrix(monkeypatch):
    """When one matrix's working set exceeds the budget, the batch runs
    through the 2-D engine and its column panels, bitwise the same."""
    a, b, c = (torch.from_numpy(x) for x in _batch("real", 2, 300, 200, 400, seed=110))
    whole = ozt.gemm_batched(a, b, c=c, beta=1.0, mode="fp64_int8_9", handle=_cpu())
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "3")
    assert engine._sub_batches(2, 300, 400, 200, 9, False, "cpu") is None
    _same(ozt.gemm_batched(a, b, c=c, beta=1.0, mode="fp64_int8_9", handle=_cpu()), whole)


def test_engine_rejects_bad_batches():
    x = torch.zeros((2, 4, 8), dtype=torch.float64)
    y = torch.zeros((2, 8, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="mismatch"):
        engine.gemm_f64_batched(x, x, 9)
    with pytest.raises(ValueError, match="mismatch"):
        engine.gemm_f64_batched(x[0], y[0], 9)
    with pytest.raises(ValueError, match="c must have shape"):
        engine.gemm_f64_batched(x, y, 9, beta=1.0, c=x)
    with pytest.raises(ValueError, match="requires c"):
        engine.gemm_f64_batched(x, y, 9, beta=1.0)
    with pytest.raises(TypeError, match="float64"):
        engine.gemm_f64_batched(x.float(), y.float(), 9)
    with pytest.raises(ValueError, match="mismatch"):
        engine.zgemm_f64_batched(x, x[:1], y, y, 9)
    assert engine.gemm_f64_batched(x[:0], y[:0], 9).shape == (0, 4, 3)


@pytest.mark.parametrize("bsz,m,n,k,tile,tiles", [
    # at short k the kept class, in units of 2 x 2 tiles of 128 x 96
    (8, 1024, 1024, 777, 2, 768),  # 8 x 4 x 6 units
    (1, 1024, 1024, 777, 2, 96),
    (64, 256, 256, 777, 2, 512),
    (2, 256, 256, 777, 2, 16),
    (5, 1000, 513, 777, 2, 240),  # 4 cluster rows of 2 tiles x 3 cluster columns of 2
    # at long k the classes without a kept triple
    (8, 1024, 1024, 16384, 0, 256),  # the whole batch fills the card with the large tile
    (1, 1024, 1024, 16384, 1, 128),  # one matrix alone: 32 large tiles would leave 100 SMs idle
    (64, 256, 256, 16384, 0, 128),
    (2, 256, 256, 16384, 1, 16),  # the small class stays reachable for a batch
    (5, 1000, 513, 16384, 0, 120),  # 4 cluster rows of 2 tiles (8 x 128 >= 1000) x 3 columns
])
def test_launch_plan_counts_the_whole_batch(bsz, m, n, k, tile, tiles):
    plan = recombine_cuda.launch_plan(m, n, k, 9, sms=132, batch=bsz)
    assert (plan.tile, plan.tiles) == (tile, tiles)
    assert plan.grid == min(132, tiles) - min(132, tiles) % plan.cluster


def test_launch_plan_refuses_a_batch_beyond_the_unit_index():
    with pytest.raises(ValueError, match="32-bit"):
        recombine_cuda.launch_plan(64, 128, 64, 9, sms=132, batch=2**31)
    with pytest.raises(ValueError, match="batch=0"):
        recombine_cuda.launch_plan(64, 128, 64, 9, sms=132, batch=0)
