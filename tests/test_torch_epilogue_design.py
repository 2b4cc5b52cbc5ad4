"""The design of the epilogue and fold kernels (csrc/epilogue.cu), held on
the CPU: the exponents by their parts (pa, pb, shift) against the plane
and the JAX package; the launch plan; and each route by which the kernels
save instructions, modelled in numpy step for step as csrc/tf32x3.cuh
takes it, against the plain functions of ops/tf32x3.py and ops/pack.py on
the domain its guard admits, with inputs just outside it refused."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core import gemm as ref_core  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.core.bits import from_f64x_planes  # noqa: E402
from ozimmu_tpu_torch.core.gemm import Exponents  # noqa: E402
from ozimmu_tpu_torch.ops import epilogue_cuda, tf32x3  # noqa: E402
from ozimmu_tpu_torch.ops.pack import pack_f64, unpack_f64  # noqa: E402
from ozimmu_tpu_torch.ops.recombine import acc_shift, recombine  # noqa: E402
from ozimmu_tpu_torch.ops.split import ZERO_ROW_PEXP, split_f64, split_f64_cols  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import crafted_triples  # noqa: E402

F32, F64 = np.float32, np.float64
M, N, B = 9, 13, 3
SHIFT = acc_shift(9, 7)


def _u64(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x, dtype=np.float64).view(np.uint64)


def _bits32(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# the exponents by their parts
# ---------------------------------------------------------------------------


def _parts(seed: int, batch: int = 0):
    """S of a product and its exponents' parts, zero rows and columns
    (the split's sentinel scale, S zero there, as the engine gives it)
    included; ``batch`` > 0 gives [B, m, n], [B, m] and [B, n]."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if batch else ()
    pa = rng.integers(-20, 20, lead + (M,)).astype(np.int32)
    pb = rng.integers(-20, 20, lead + (N,)).astype(np.int32)
    pa[..., 2] = ZERO_ROW_PEXP
    pb[..., 5] = ZERO_ROW_PEXP
    v = rng.uniform(-4, 4, lead + (M, N))
    v[..., 2, :] = 0.0
    v[..., :, 5] = 0.0
    S, _ = unpack_f64(torch.from_numpy(v))
    return S, torch.from_numpy(pa), torch.from_numpy(pb)


def _jax_S(S):
    return tuple(jnp.asarray(s.numpy()) for s in S)


def _jax_plane(pa, pb):
    pa, pb = jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy())
    return (pa[..., :, None] + pb[..., None, :] - SHIFT).astype(jnp.int32)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("beta", [0.0, 1.0, -0.5])
@pytest.mark.parametrize("alpha", [1.0, -1.0, 2.5, 0.1])
def test_exponent_parts_equal_the_plane_and_the_reference(alpha, beta, batched):
    """``_epilogue_SE`` with :class:`Exponents` == with the plane ==
    ``ozimmu_tpu.core.gemm._epilogue_SE`` on the JAX package's plane
    ``pa[:, None] + pb[None, :] - shift``, bit for bit, matrix by matrix
    for a batch."""
    S, pa, pb = _parts(seed=1, batch=B if batched else 0)
    rng = np.random.default_rng(2)
    c = torch.from_numpy(rng.uniform(-2, 2, S[0].shape)) if beta != 0.0 else None
    E = Exponents(pa, pb, SHIFT)
    got = core._epilogue_SE(S, E, alpha, beta, c)
    np.testing.assert_array_equal(_u64(got), _u64(core._epilogue_SE(S, E.plane(), alpha, beta, c)))
    for i in range(B) if batched else [None]:
        pick = (lambda x: x[i]) if batched else (lambda x: x)  # noqa: E731
        jc = None if c is None else F64X.from_numpy(pick(c).numpy())
        ref = ref_core._epilogue_SE(_jax_S(tuple(map(pick, S))), _jax_plane(pick(pa), pick(pb)),
                                    alpha, beta, jc)
        np.testing.assert_array_equal(_u64(pick(got)), _u64(from_f64x_planes(ref.hi, ref.lo)))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("beta", [0.0, 1.0, 1.25 + 0.5j])
@pytest.mark.parametrize("alpha", [1.0, 0.5 - 1.5j, -1j])
def test_exponent_parts_fold_equals_the_plane_and_the_reference(alpha, beta, batched):
    """``_zfold_passes`` with each pass's :class:`Exponents` == with the
    planes == ``ozimmu_tpu.core.gemm._zfold_passes``; a batch by its
    [B*m, n] rows with exponents [B, m] and [B, n], as the engine passes
    it."""
    bsz = B if batched else 1
    rows = bsz * M
    SEs, planes = [], []
    for p in range(4):
        S, pa, pb = _parts(seed=10 + p, batch=B if batched else 0)
        S = tuple(s.reshape(rows, N) for s in S)
        E = Exponents(pa, pb, SHIFT)
        SEs.append((S, E))
        planes.append((S, E.plane().reshape(rows, N)))
    rng = np.random.default_rng(3)
    c_re, c_im = (torch.from_numpy(rng.uniform(-2, 2, (rows, N))) for _ in range(2))
    args = (complex(alpha), complex(beta), c_re, c_im, "cpu")
    got = core._zfold_passes(SEs, rows, N, *args)
    want = core._zfold_passes(planes, rows, N, *args)
    jSEs = [(_jax_S(S), jnp.asarray(E.numpy())) for S, E in planes]
    jc = [F64X.from_numpy(x.numpy()) for x in (c_re, c_im)]
    ref = ref_core._zfold_passes(jSEs, rows, N, complex(alpha), complex(beta), *jc)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(_u64(g), _u64(w))
        np.testing.assert_array_equal(_u64(g), _u64(from_f64x_planes(r.hi, r.lo)))


def test_engine_hands_the_epilogue_exponent_parts(monkeypatch):
    """The real, chunked, complex and batched cores give the epilogue and
    the fold :class:`Exponents`, never a plane."""
    import ozimmu_tpu_torch as ozt

    seen = []
    epi, fold = core._epilogue_SE, core._zfold_passes
    monkeypatch.setattr(core, "_epilogue_SE",
                        lambda S, E, *a, **k: seen.append(E) or epi(S, E, *a, **k))
    monkeypatch.setattr(core, "_zfold_passes",
                        lambda SEs, *a, **k: seen.extend(E for _, E in SEs) or fold(SEs, *a, **k))
    rng = np.random.default_rng(4)
    mk = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s))  # noqa: E731
    core.gemm_f64(mk(7, 20), mk(20, 11), 9, n_chunks=1)
    core.gemm_f64(mk(7, 20), mk(20, 11), 9, n_chunks=2)
    core.zgemm_f64(mk(7, 20), mk(7, 20), mk(20, 11), mk(20, 11), 9)
    core.gemm_f64_batched(mk(2, 7, 20), mk(2, 20, 11), 9)
    ozt.gemm_batched(mk(2, 7, 20) + 0j, mk(2, 20, 11) + 0j, mode="fp64_int8_9")
    # one panel, two panels, four passes, the batch, four batched passes
    assert len(seen) == 1 + 2 + 4 + 1 + 4
    assert all(isinstance(E, Exponents) and E.shift == acc_shift(9, bits_per_int8(20))
               for E in seen)


# ---------------------------------------------------------------------------
# the launch plan: tiles, vector body, one-column tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,aligned,n_body,block", [
    (8192, 8192, True, 8192, (256, 1)),   # the main path: every row a vector body
    (15360, 15360, True, 15360, (256, 1)),
    (1031, 1029, True, 0, (256, 1)),      # odd n: every column through the tail
    (1024, 1026, True, 0, (256, 1)),      # n % 4 == 2, likewise
    (300, 260, False, 0, (256, 1)),       # a misaligned plane
    (100, 130, True, 0, (256, 1)),
    (256, 256, True, 256, (64, 4)),       # short rows: threads go down the rows
    (1000, 4, True, 4, (32, 8)),
    (7, 3, True, 0, (32, 8)),
])
def test_launch_plan_tiles(m, n, aligned, n_body, block):
    plan = epilogue_cuda.launch_plan(1, m, n, 132, aligned)
    assert plan.n_body == n_body and plan.block == block
    tx, ty = block
    steps = n_body // epilogue_cuda.VEC + (n - n_body)
    assert plan.grid[0] == math.ceil(steps / tx)  # every column, one step a thread
    assert plan.band % ty == 0 or plan.band == m
    assert plan.bands == math.ceil(m / plan.band) and plan.blocks == plan.bands
    assert plan.band <= ty * epilogue_cuda.MAX_ROWS_PER_THREAD


def test_launch_plan_batch_and_grid_limits():
    plan = epilogue_cuda.launch_plan(8, 1024, 1024, 132, True)
    assert plan.blocks == 8 * plan.bands and plan.grid[1] == plan.blocks and plan.grid[2] == 1
    many = epilogue_cuda.launch_plan(100000, 2, 8, 132, True)
    assert many.grid[1] == epilogue_cuda.GRID_Y and many.grid[1] * many.grid[2] >= many.blocks
    assert (many.grid[2] - 1) * many.grid[1] < many.blocks


@pytest.mark.parametrize("offset,n,wide", [(0, 64, True), (2, 64, True), (1, 64, False),
                                           (3, 64, False), (4, 61, True)])
def test_wide_rows_of_column_panels(offset, n, wide):
    """A column panel ``out[:, j0:j1]`` of an f64 matrix takes two doubles
    a store only where every row starts on 16 bytes: an even offset and an
    even row stride (the kernel asks only where the row has a vector body)."""
    big = torch.zeros((5, 130), dtype=torch.float64)
    panel = big[:, offset:offset + n]
    assert epilogue_cuda._wide_rows(panel, panel.stride(0)) == wide
    odd_rows = torch.zeros((5, 129), dtype=torch.float64)[:, offset:offset + n]
    assert not epilogue_cuda._wide_rows(odd_rows, odd_rows.stride(0))
    assert not epilogue_cuda._wide_rows(big.t()[:n, :5], 1)  # strided columns


def test_aligned_planes():
    x = torch.zeros(64, dtype=torch.float32)
    assert epilogue_cuda._aligned16(x, x[4:])
    assert not epilogue_cuda._aligned16(x, x[1:])
    assert not epilogue_cuda._aligned16(x[2:])


# ---------------------------------------------------------------------------
# numpy models of csrc/tf32x3.cuh, step for step
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def _renorm(t0, t1, t2):
    s, e2 = _quick_two_sum(t1, t2)
    s0, e1 = _quick_two_sum(t0, s)
    s1, s2 = _quick_two_sum(e1, e2)
    s0, s1 = _quick_two_sum(s0, s1)
    return s0, s1, s2


def _add_term(acc, x):
    s0, e0 = _two_sum(acc[0], x)
    s1, e1 = _two_sum(acc[1], e0)
    return s0, s1, acc[2] + e1


def _two_prod_fma(a, b):
    """two_prod_fma: the f32 product and its error rounded once; the
    product of two f32 is exact in f64, and so is its difference from p."""
    p = a * b
    return p, (a.astype(F64) * b.astype(F64) - p.astype(F64)).astype(F32)


def _two_prod_dekker(a, b):
    def split(x):
        c = F32(4097.0) * x
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _mul_fma(x, y):
    """mul_t<true>: tf32x3.mul with the FMA TwoProd."""
    p00, e00 = _two_prod_fma(x[0], y[0])
    p01, e01 = _two_prod_fma(x[0], y[1])
    p10, e10 = _two_prod_fma(x[1], y[0])
    t2 = (x[1] * y[1] + (x[0] * y[2] + x[2] * y[0])) + (e01 + e10)
    acc = (p00, e00, np.zeros_like(p00))
    for term in (p01, p10, t2):
        acc = _add_term(acc, term)
    return _renorm(*acc)


def _fma_admits(x, floors):
    """mul_fma_exact"""
    a0, a1 = np.abs(x[0]), np.abs(x[1])
    big = F32(2.0**100)
    return (((a0 == 0) | ((a0 >= F32(floors[0])) & (a0 < big)))
            & ((a1 == 0) | ((a1 >= F32(floors[1])) & (a1 < big))))


def _unpack_fast(c: np.ndarray):
    """csrc/tf32x3.cuh::unpack_f64: the components from the halves' bits,
    magic-number conversions, the sign bit or'ed in."""
    bits = np.ascontiguousarray(c, dtype=F64).view(np.uint64)
    hi = (bits >> np.uint64(32)).astype(np.uint32)
    lo = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    field = ((hi >> np.uint32(20)) & np.uint32(0x7FF)).astype(np.int32)
    m_hi = (hi & np.uint32(0xFFFFF)) | np.where(field > 0, np.uint32(0x100000), np.uint32(0))
    sign = hi & np.uint32(0x80000000)

    def scaled(m, s):
        magic = np.uint32((127 + 23 + s) << 23)
        v = (magic | m.astype(np.uint32)).view(F32) - np.array([magic], np.uint32).view(F32)[0]
        return (v.view(np.uint32) | sign).view(F32)

    E = np.where(field > 0, field, 1) - 1075
    return (scaled(m_hi, 32), scaled(lo >> np.uint32(16), 16), scaled(lo & np.uint32(0xFFFF), 0)), \
        E.astype(np.int32)


def _pack_fast(t, E, guarded: bool = True):
    """csrc/tf32x3.cuh::pack_f64: renorm, then :func:`_pack_fast_renormed`."""
    return _pack_fast_renormed(_renorm(*t), E, guarded)


def _pack_fast_renormed(t, E, guarded: bool = True):
    """csrc/tf32x3.cuh::pack_f64 after its renorm: a zero or f32-subnormal
    head packs to a signed zero; else Fast2Sum, TwoSum, round to odd, one
    add and the scaling by 2^E in f64, admitted where the sum is at least
    2^(-1022 - E).  Returns (admitted, bits): where not admitted
    the kernel takes the integer route.  ``guarded=False`` applies the f64
    route to every finite head (to show what the guard keeps out)."""
    t0, t1, t2 = t
    b0 = t0.view(np.uint32)
    ef0 = (b0 >> np.uint32(23)) & np.uint32(0xFF)
    zero = ef0 == 0
    E = np.asarray(E).astype(np.int64)
    tail = F32(2.0**-20) * np.abs(t0)
    small = (np.abs(t1) <= tail) & (np.abs(t2) <= tail)
    ok = ~zero & (ef0 != 0xFF) & (small if guarded else True) \
        & ((E >= -1022) & (E <= 1023) if guarded else True)
    d0, d1, d2 = (x.astype(F64) for x in (t0, t1, t2))
    with np.errstate(over="ignore", invalid="ignore"):
        h = d0 + d1
        low = d1 - (h - d0)
        m = low + d2
        z = m - low
        err = (low - (m - z)) + (d2 - z)
        rz = np.where((err == 0) | (np.sign(err) == np.sign(m)), m, np.nextafter(m, 0.0))
        odd = np.where(err == 0, m, (rz.view(np.int64) | 1).view(F64))
        s = h + odd
        if guarded:  # decided on the sum, before the scaling: |s| >= 2^(-1022 - E)
            Ec = np.clip(E, -1022, 1023)
            ok &= np.abs(s) >= (np.maximum(1 - Ec, 1) << 52).view(F64)
            r = s * ((Ec + 1023) << 52).view(F64)
        else:
            r = np.ldexp(s, np.clip(E, -2000, 2000))
    bits = np.where(zero, (b0 & np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32),
                    r.view(np.uint64))
    return ok | zero, bits


def _scalars():
    """Scalars of every kind: integers, 24-bit fractions, full 53-bit
    mantissas (a triple with a tail), wide exponents, both signs."""
    rng = np.random.default_rng(5)
    vals = [1.0, -1.0, 2.0, 2.5, -0.5, 0.1, 1.0 / 3.0, -2.0 / 7.0, 1e-30, -3e25, 0.0]
    vals += list(rng.standard_normal(12) * 2.0 ** rng.integers(-60, 60, 12))
    return vals


def _recombine_S(ns: int, k: int, seed: int):
    """S of the plain recombine on operands with a wide exponent spread
    (cancellations give heads far below the product's scale)."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((60, k)) * np.exp(rng.standard_normal((60, k)) * 4))
    b = torch.from_numpy(rng.standard_normal((k, 50)))
    bb = bits_per_int8(k)
    da, _ = split_f64(a, ns, bb)
    db, _ = split_f64_cols(b, ns, bb)
    return recombine(da, db, ns, bb, k)


def _inputs(kind: str):
    if kind.startswith("recombine"):
        ns = int(kind.split("_")[1])
        return tuple(s.numpy() for s in _recombine_S(ns, 300, seed=ns))
    if kind == "unpacked":
        rng = np.random.default_rng(6)
        c = rng.standard_normal((80, 80)) * 2.0 ** rng.integers(-1000, 1000, (80, 80))
        c.reshape(-1)[::7] = rng.choice([0.0, -0.0, 5e-324, -2.0**-1030, 1.7e308], c.size // 7 + 1)
        return tuple(t.numpy() for t in unpack_f64(torch.from_numpy(c))[0])
    S, _, _ = crafted_triples(96, 41, seed=7)
    return tuple(s.numpy() for s in S)


# ---------------------------------------------------------------------------
# TwoProd by FMA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo", [-103, -90, -60, -20, 20, 60])
def test_fma_two_prod_equals_dekker_where_both_are_exact(lo):
    """Normal factors whose exponents sum to ``lo`` .. ``lo + 10`` (at least
    -103, the edge below which the error has no f32 quantum): the same p
    and the same e, bit for bit, signed zeros included."""
    rng = np.random.default_rng(100 - lo)
    n = 200_000
    s = rng.integers(lo, lo + 11, n)
    ea = rng.integers(np.maximum(-126, s - 100), np.minimum(100, s + 126) + 1)
    a = (rng.uniform(1, 2, n) * 2.0 ** ea * rng.choice([-1, 1], n)).astype(F32)
    b = (rng.uniform(1, 2, n) * 2.0 ** (s - ea) * rng.choice([-1, 1], n)).astype(F32)
    a[::97] = rng.integers(-2**23, 2**23, a[::97].size).astype(F32)  # exact products
    b[::89] = 0.0
    for x, y in ((a, b), (b, a)):
        p_d, e_d = _two_prod_dekker(x, y)
        p_f, e_f = _two_prod_fma(x, y)
        np.testing.assert_array_equal(_bits32(p_d), _bits32(p_f))
        np.testing.assert_array_equal(_bits32(e_d), _bits32(e_f))


def test_fma_two_prod_differs_from_dekker_below_the_edge():
    """Why the guard exists: with the exponents summing below -103 the two
    TwoProds part on some inputs."""
    rng = np.random.default_rng(8)
    n = 1_000_000
    ea = rng.integers(-100, -10, n)
    a = (rng.uniform(1, 2, n) * 2.0 ** ea).astype(F32)
    b = (rng.uniform(1, 2, n) * 2.0 ** (-112 - ea)).astype(F32)
    with np.errstate(under="ignore"):
        assert (_bits32(_two_prod_dekker(a, b)[1]) != _bits32(_two_prod_fma(a, b)[1])).any()


def test_fma_floors():
    ff = epilogue_cuda.fma_floors
    assert ff((1.0, 0.0, 0.0)) == (2.0**-100, 2.0**-100)
    assert ff((-2.0, 0.0, 0.0)) == (2.0**-101, 2.0**-101)
    t, _ = tf32x3.from_f64_host(0.1)
    assert t[1] != 0.0 and ff(t) == (2.0 ** (-100 - (math.frexp(t[1])[1] - 1)), 2.0**-100)
    assert ff(t)[0] <= 2.0**-48  # y1 >= 2^-52: a head from 2^-48 up takes the FMA
    assert ff((0.0, 0.0, 0.0)) == (0.0, 0.0)


@pytest.mark.parametrize("kind", ["recombine_3", "recombine_9", "recombine_18", "unpacked",
                                  "crafted"])
def test_mul_fma_route_equals_mul(kind):
    """``mul`` with the FMA TwoProd == ``tf32x3.mul`` bit for bit wherever
    ``mul_fma_exact`` admits x, for scalars of every kind; S of recombine
    and unpacked c are admitted whole for the integer scalars."""
    x = _inputs(kind)
    for v in _scalars():
        t, _ = tf32x3.from_f64_host(v)
        y = tuple(np.full(x[0].shape, F32(c)) for c in t)
        floors = epilogue_cuda.fma_floors(t)
        ok = _fma_admits(x, floors)
        with np.errstate(all="ignore"):
            got = _mul_fma(x, y)
        want = tf32x3.mul(tuple(map(torch.from_numpy, x)), tuple(map(torch.from_numpy, y)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits32(g)[ok], _bits32(w.numpy())[ok], err_msg=f"{v}")
        if kind != "crafted" and t[1] == 0.0:
            assert ok.all(), v


def test_fma_guard_refuses_just_outside():
    t, _ = tf32x3.from_f64_host(0.1)
    f0, f1 = epilogue_cuda.fma_floors(t)
    below0, below1 = np.nextafter(F32(f0), F32(0)), np.nextafter(F32(f1), F32(0))
    x0 = np.array([f0, below0, 1.0, 1.0, 2.0**100, 0.0, -below0, 1e-45], dtype=F32)
    x1 = np.array([f1, 0.0, below1, 2.0**100, 0.0, f1, 0.0, 0.0], dtype=F32)
    assert _fma_admits((x0, x1), (f0, f1)).tolist() == [True, False, False, False, False, True,
                                                        False, False]


def test_minus_one_keeps_its_mul():
    """Why a factor of -1 (HPL's alpha) is multiplied and not skipped:
    ``mul(S, (-1, 0, 0))`` is not ``-S`` bit for bit on every S of
    recombine (S of ns = 3 here)."""
    S = _recombine_S(3, 300, seed=3)
    minus = tuple(torch.tensor(v, dtype=torch.float32) for v in (-1.0, 0.0, 0.0))
    got = tf32x3.mul(S, minus)
    assert any((g.view(torch.int32) != (-s).view(torch.int32)).any() for g, s in zip(got, S))


# ---------------------------------------------------------------------------
# unpack from the halves' bits
# ---------------------------------------------------------------------------


def test_unpack_fast_equals_unpack_f64():
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2**63, 300_000, dtype=np.int64).astype(np.uint64)
    bits[::2] |= np.uint64(1 << 63)
    c = bits.view(F64).copy()
    special = [0.0, -0.0, 5e-324, -5e-324, 2.0**-1022, -1.7976931348623157e308, 1.0, -1.5,
               2.0**-1074 * 3, np.inf, -np.inf, np.nan]
    c[:len(special)] = special
    got, gE = _unpack_fast(c)
    want, wE = unpack_f64(torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits32(g), _bits32(w.numpy()))
    np.testing.assert_array_equal(gE, wE.numpy())


# ---------------------------------------------------------------------------
# pack through FP64
# ---------------------------------------------------------------------------


def _pack_cases(kind: str):
    rng = np.random.default_rng(11)
    n = 300_000
    if kind == "crafted":
        S, E, _ = crafted_triples(400, 301, seed=12)
        return tuple(s.numpy() for s in S), E.numpy()
    if kind == "epilogue":  # what pack meets in the kernel: mul and aligned_add outputs
        S, pa, pb = _parts(seed=13)
        E = Exponents(pa, pb, SHIFT).plane()
        t, te = tf32x3.from_f64_host(-2.5)
        S = tf32x3.mul(S, tuple(torch.full((), v, dtype=torch.float32) for v in t))
        ct, cE = unpack_f64(torch.from_numpy(rng.uniform(-2, 2, (M, N))))
        from ozimmu_tpu_torch.ops.pack import aligned_add
        S, E = aligned_add(S, E + te, ct, cE)
        return tuple(s.numpy() for s in S), E.numpy()
    if kind == "ties":  # t0 + t1 on an f64 grid point, t2 an exact half or just past it
        t0 = (1 + rng.integers(0, 2**23, n) * 2.0**-23).astype(F32)
        t1 = (rng.integers(-2**23, 2**23, n) * 2.0**-47).astype(F32)
        half = np.where(rng.random(n) < 0.5, 2.0**-53, -2.0**-53)
        t2 = np.where(rng.random(n) < 0.5, half, half * (1 + 2.0**-12)).astype(F32)
        return (t0, t1, t2), rng.integers(-60, 60, n).astype(np.int32)
    if kind == "overflow":  # near 2^1024: the carry to inf and outright overflow
        t0 = (2 - rng.integers(0, 4, n) * 2.0**-23).astype(F32)
        t1 = (rng.choice([-1, 1], n) * rng.integers(0, 2**23, n) * 2.0**-47).astype(F32)
        t2 = (rng.uniform(-1, 1, n) * 2.0**-72).astype(F32)
        return (t0, t1, t2), rng.choice([1020, 1021, 1022, 1023], n).astype(np.int32)
    if kind == "subnormal edge":  # (t0 + t1 + t2) * 2^E on both sides of 2^-1022
        sgn = rng.choice([-1.0, 1.0], n)
        t0 = ((1 + rng.integers(-8, 8, n) * 2.0**-24) * sgn).astype(F32)
        t1 = (rng.integers(-2**23, 2**23, n) * 2.0**-47 * sgn).astype(F32)
        t1[::3] = (-(2.0**-53) * sgn[::3]).astype(F32)
        t2 = (rng.choice([-1.0, 0.0, 1.0], n) * 2.0 ** rng.integers(-90, -54, n)).astype(F32)
        return (t0, t1, t2), rng.integers(-1024, -1019, n).astype(np.int32)
    x0 = rng.uniform(1, 2, n) * 2.0 ** rng.integers(-125, 127, n) * rng.choice([-1, 1], n)
    x0 = x0.astype(F32)
    x1 = (x0.astype(F64) * rng.uniform(-1, 1, n) * 2.0 ** -rng.integers(24, 70, n)).astype(F32)
    x2 = (x1.astype(F64) * rng.uniform(-1, 1, n) * 2.0 ** -rng.integers(24, 70, n)).astype(F32)
    return (x0, x1, x2), rng.integers(-1200, 1200, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["crafted", "epilogue", "ties", "overflow", "random",
                                  "subnormal edge"])
def test_pack_fp64_route_equals_pack_f64(kind):
    t, E = _pack_cases(kind)
    with np.errstate(all="ignore"):
        ok, bits = _pack_fast(t, E)
    want = _u64(pack_f64(tuple(map(torch.from_numpy, t)), torch.from_numpy(E)))
    np.testing.assert_array_equal(bits[ok], want[ok])
    if kind in ("epilogue", "ties", "overflow"):
        assert ok.all()
    elif kind == "subnormal edge":  # E = -1021 admits all, E < -1022 none
        assert ok[E == -1021].all() and not ok[E < -1022].any()
        assert ok[E == -1022].any() and not ok[E == -1022].all()
    else:
        assert ok.mean() > 0.5


def test_pack_fp64_guard_refuses_f64_subnormals():
    """A result below 2^-1022 rounds at another place than the f64 sum:
    the guard sends it to the integer route, and the f64 route without the
    guard would give other bits there (double rounding)."""
    rng = np.random.default_rng(14)
    n = 100_000
    t0 = (1 + rng.integers(0, 2**23, n) * 2.0**-23).astype(F32)
    t1 = (rng.integers(-2**23, 2**23, n) * 2.0**-47).astype(F32)
    t2 = (rng.uniform(-1, 1, n) * 2.0**-60).astype(F32)
    E = rng.integers(-1060, -1023, n).astype(np.int32)
    with np.errstate(all="ignore"):
        ok, _ = _pack_fast((t0, t1, t2), E)
        _, loose = _pack_fast((t0, t1, t2), E, guarded=False)
    assert not ok.any()
    want = _u64(pack_f64(tuple(map(torch.from_numpy, (t0, t1, t2))), torch.from_numpy(E)))
    assert (loose != want).any()
    # E = -1022 itself: (1, -2^-53, t2) sums to 1 - 2^-53 in f64 for t2 =
    # -2^-80, 0, +2^-80, and scaled that is the tie 2^-1022 - 2^-1075, which
    # rounds to even (2^-1022); the exact values lie below, on and above it.
    # The result 2^-1022 passes a test of |s * 2^E| >= 2^-1022 made after
    # the scaling, but below the tie the right result is 2^-1022 - 2^-1074:
    # the guard tests the sum before scaling and refuses all three.
    edge = (np.array([1, -1, 1, -1, 1, -1], dtype=F32),
            np.array([-2.0**-53, 2.0**-53] * 3, dtype=F32),
            np.array([-2.0**-80, 2.0**-80, 0, 0, 2.0**-80, -2.0**-80], dtype=F32))
    Ee = np.full(6, -1022, dtype=np.int32)
    with np.errstate(all="ignore"):
        ok, _ = _pack_fast(edge, Ee)
        _, loose = _pack_fast(edge, Ee, guarded=False)
    assert not ok.any()
    assert abs((1 - 2.0**-53) * 2.0**-1022) >= 2.0**-1022
    want = _u64(pack_f64(tuple(map(torch.from_numpy, edge)), torch.from_numpy(Ee)))
    below, top = np.uint64(0x000FFFFFFFFFFFFF), np.uint64(1 << 52)  # 2^-1022 - 2^-1074, 2^-1022
    sign = np.uint64(1 << 63)
    assert want.tolist() == [below, below | sign, top, top | sign, top, top | sign]
    assert (loose[:2] != want[:2]).all() and (loose[2:] == want[2:]).all()


def test_pack_fp64_guard_refuses_wide_tails_and_far_exponents():
    """After renorm the tails lie 24 binades below the head (no renorm
    output in these tests comes near 2^-20); the guard that the f64 steps
    need refuses the rest, and exponents outside [-1022, 1023]."""
    t0 = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 2.0**-130, -0.0, np.inf], dtype=F32)
    t1 = np.array([2.0**-21, 2.0**-19, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=F32)
    t2 = np.array([0.0, 0.0, 2.0**-19, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=F32)
    E = np.array([0, 0, 0, 1024, -1023, 0, 0, 0], dtype=np.int32)
    with np.errstate(all="ignore"):
        ok, bits = _pack_fast_renormed((t0, t1, t2), E)
    # the zero and f32-subnormal heads are the signed zeros of pack_renormed
    assert ok.tolist() == [True, False, False, False, False, True, True, False]
    assert bits[5] == 0 and bits[6] == np.uint64(1 << 63)


# ---------------------------------------------------------------------------
# the fold's slots
# ---------------------------------------------------------------------------


def _fold_by_slots(SEs, plan, c_re, c_im):
    """The kernel's fold (zfold_one): sources first, then the twelve slots
    in their fixed order, each adding its step where the plan has one."""
    slots = {epilogue_cuda._slot(st): st for st in plan.steps}
    shape = SEs[0][1].shape

    def empty():
        return tf32x3.zeros(shape), torch.full(shape, core._EMPTY_EXP, dtype=torch.int32)

    ct = [unpack_f64(x) if x is not None else empty() for x in (c_re, c_im)]
    acc = [ct[0], ct[1]] if plan.init_from_c else [empty(), empty()]
    sources = [ct[0], ct[0], ct[1], ct[1]] + [SEs[p] for p in range(4) for _ in (0, 1)]
    for k in range(epilogue_cuda.MAX_STEPS):
        if k in slots:
            st = slots[k]
            assert st.dst == k % 2
            S, E = sources[k]
            f = tuple(torch.full((), v, dtype=torch.float32) for v in st.triple)
            from ozimmu_tpu_torch.ops.pack import aligned_add
            acc[k % 2] = aligned_add(*acc[k % 2], tf32x3.mul(S, f), E + st.exp)
    return pack_f64(*acc[0]), pack_f64(*acc[1])


@pytest.mark.parametrize("beta", [0.0, 1.0, -1.0, 2j, 1.25 + 0.5j])
@pytest.mark.parametrize("alpha", [0.0, 1.0, -1j, 0.5 - 1.5j])
def test_fold_slots_follow_the_plan(alpha, beta):
    """Every step of ``zfold_plan`` lands in the slot the kernel runs it
    from, in the plan's order; run slot by slot, it equals ``zfold_plain``
    bit for bit."""
    plan = epilogue_cuda.zfold_plan(alpha, beta)
    slots = [epilogue_cuda._slot(st) for st in plan.steps]
    assert slots == sorted(set(slots))
    rng = np.random.default_rng(15)
    SEs = [unpack_f64(torch.from_numpy(rng.uniform(-4, 4, (M, N)))) for _ in range(4)]
    c_re, c_im = (torch.from_numpy(rng.uniform(-2, 2, (M, N))) for _ in range(2))
    for g, w in zip(_fold_by_slots(SEs, plan, c_re, c_im),
                    epilogue_cuda.zfold_plain(SEs, plan, c_re, c_im)):
        np.testing.assert_array_equal(_u64(g), _u64(w))


# ---------------------------------------------------------------------------
# SASS counts per element (tools/torch_epilogue_sass.py), on listings in
# cuobjdump's format
# ---------------------------------------------------------------------------


def _sass_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_epilogue_sass.py")
    spec = importlib.util.spec_from_file_location("torch_epilogue_sass", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _listing(name, ops):
    lines = [f"\t\tFunction : {name}"]
    for i, op in enumerate(ops):
        lines.append(f"        /*{16 * i:04x}*/                   {op} ;   /* 0x0000 */")
        lines.append("                                                   /* 0x000fe */")
    return "\n".join(lines)


_EPILOGUE_SASS = [
    "S2R R0, SR_TID.X",                      # 0x00
    "IMAD R1, R0, 0x4, RZ",                  # 0x10 row loop from here
    "LDG.E.128 R4, desc[UR4][R2.64]",        # 0x20 vector loop from here
    "DMUL R8, R6, R8", "DMUL R10, R6, R10", "DMUL R12, R6, R12", "DMUL R14, R6, R14",
    "@P0 STG.E.128 desc[UR4][R2.64], R8", "@P0 STG.E.128 desc[UR4][R2.64+0x10], R12",
    "@!P0 STG.E.64 desc[UR4][R2.64], R8", "@!P0 STG.E.64 desc[UR4][R2.64+0x8], R10",
    "@!P0 STG.E.64 desc[UR4][R2.64+0x10], R12", "@!P0 STG.E.64 desc[UR4][R2.64+0x18], R14",
    "CALL.REL.NOINC 0x0170",                  # 0xd0
    "@P1 BRA 0x0020",                         # 0xe0 vector loop back
    "LDG.E R4, desc[UR4][R2.64]",             # 0xf0 tail loop from here
    "DMUL R8, R6, R8", "NOP", "STG.E.64 desc[UR4][R2.64], R8",
    "@P2 BRA 0x00f0",                         # 0x130 tail loop back
    "@P3 BRA 0x0010",                         # 0x140 row loop back
    "EXIT", "BRA 0x0160",                     # the trap after EXIT
    "RET.REL.NODEC R20 0x0",                  # 0x170, the callee's body
]

_STEP_LOOP_SASS = [
    "S2R R0, SR_TID.X",                      # 0x00 element loop from here
    "LDG.E R4, desc[UR4][R2.64]",
    "IADD3 R5, R5, 0x1, RZ",                 # 0x20 step loop from here
    "FMUL R6, R6, R7", "FADD R6, R6, R7",
    "@P0 BRA 0x0020",                         # 0x50 step loop back
    "STG.E.64 desc[UR4][R2.64], R6", "STG.E.64 desc[UR4][R8.64], R6",
    "@P1 BRA 0x0000",                         # 0x80 element loop back
    "EXIT",
]


def test_sass_element_loops_count_per_element():
    """A 4-column body (its elements counted by the FP64 pack's DMUL, not
    its two store paths) and a one-column tail inside a row loop; a fold's
    element loop with a loop over its steps inside it, counted once per step;
    NOPs, the trap after EXIT and callees' bodies left out."""
    t = _sass_tool()
    funcs = t.functions(_listing("epilogue_kernelILb0ELb0ELb0ELb0E", _EPILOGUE_SASS) + "\n"
                        + _listing("zfold_kernel", _STEP_LOOP_SASS))
    epi, fold = funcs["epilogue_kernelILb0ELb0ELb0ELb0E"], funcs["zfold_kernel"]
    assert len(epi) == len(_EPILOGUE_SASS) - 1  # the NOP
    assert t.sass_counts(funcs)["epilogue_kernelILb0ELb0ELb0ELb0E"] == 22
    assert t.element_loops(epi, 1) == [
        {"loop": "0x20-0xe0", "instructions": 13, "elements": 4, "per_element": 3.25,
         "step_loop": 0},
        {"loop": "0xf0-0x130", "instructions": 4, "elements": 1, "per_element": 4.0,
         "step_loop": 0}]
    assert t.element_loops(fold, 2) == [
        {"loop": "0x0-0x80", "instructions": 5, "elements": 1, "per_element": 5.0,
         "step_loop": 4}]
    kernels = {"epilogue_kernel<0, 0, 0, 0>": {"element_loops": t.element_loops(epi, 1)},
               "zfold_kernel": {"element_loops": t.element_loops(fold, 2)}}
    per = t.built_per_element(kernels)
    assert per["epilogue alpha=1 beta=0"] == 3.25 and per["epilogue alpha beta"] is None
    assert per["fold alpha=1 (4 steps)"] == 5 + 4 * 4
    assert per["fold complex alpha, beta, c (12 steps)"] == 5 + 12 * 4
