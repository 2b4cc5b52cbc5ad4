"""The split stage's k-major plane layout on the CPU, against ozimmu_tpu:
the plain split with ``k_pad`` (A [ns, rows, k_pad], B [ns, cols, k_pad],
zero beyond k) equals the JAX package's planes transposed and padded, bit
for bit; the plain ``row_exponent`` equals the JAX one; the plain
recombine on k-major B equals it on [ns, k, n] and ozimmu_tpu's; the
recombine wrapper's ``_k_major`` check raises instead of copying; the
split and exponent kernels' launch plans; and the engine hands recombine
the planes as its split wrote them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import recombine as RR  # noqa: E402
from ozimmu_tpu.ops import split as R  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch import schedule  # noqa: E402
from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.ops import exponent_cuda, recombine_cuda, split_cuda  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as P_rec  # noqa: E402
from ozimmu_tpu_torch.ops import split as P  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402

KS = [1, 15, 16, 17, 777]
NS_B = [(3, 7), (9, 5), (18, 7), (3, 5), (9, 7), (18, 5)]


def _special(rows, cols, seed=3):
    """Zero row and column, subnormals, -0.0 and extreme magnitudes, where
    the shape has room for them."""
    x = np.random.default_rng(seed).standard_normal((rows, cols))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    for i, v in enumerate((5e-324, -1e-310, -0.0, 1e300, -1e-300), start=1):
        if i < rows and i < cols:
            x[i, i] = v
    return x


def _matrix(name, shape, seed):
    return _special(*shape, seed=seed) if name == "special" else generate_input(name, shape, seed=seed)


def _jax_planes(x, ns, b, axis):
    fx = F64X.from_numpy(np.ascontiguousarray(x))
    d, p = (R.split_f64x if axis == 1 else R.split_f64x_cols)(fx, ns, b)
    return np.asarray(d), np.asarray(p)


def _k_major_np(d, axis, k_pad):
    """JAX planes [ns, rows, k] (A) or [ns, k, cols] (B) as [ns, ., k_pad]."""
    if axis == 0:
        d = np.swapaxes(d, -1, -2)
    pad = [(0, 0)] * (d.ndim - 1) + [(0, k_pad - d.shape[-1])]
    return np.pad(d, pad)


@pytest.mark.parametrize("ns,b", NS_B)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["normal01", "exp_rand-8", "special"])
def test_k_major_planes_equal_the_jax_planes(name, k, ns, b):
    """A [9, k] by rows and B [k, 11] by columns: k-major planes padded to
    the next multiple of 16 (and to 16 more) == ozimmu_tpu's planes,
    transposed (B) and zero-padded, bit for bit; the scales unchanged."""
    a = _matrix(name, (9, k), seed=k)
    bm = _matrix(name, (k, 11), seed=k + 1)
    kp = P_rec.padded_k(k)
    assert kp % 16 == 0 and k <= kp < k + 16
    for x, axis, fn in ((a, 1, P.split_f64), (bm, 0, P.split_f64_cols)):
        want_d, want_p = _jax_planes(x, ns, b, axis)
        for pad in (kp, kp + 16):
            got_d, got_p = fn(torch.from_numpy(x), ns, b, pad)
            assert got_d.dtype == torch.int8 and got_d.is_contiguous()
            np.testing.assert_array_equal(got_d.numpy(), _k_major_np(want_d, axis, pad))
            np.testing.assert_array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("ns,b", [(3, 7), (9, 5), (18, 7)])
@pytest.mark.parametrize("axis", [0, 1])
def test_k_major_batch_equals_each_matrix(axis, ns, b):
    """A batch [3, 40, 23] (k = 23 for A, 40 for B) split k-major in one
    call == each matrix's JAX planes, transposed and padded."""
    x = generate_input("exp_rand-8", (3, 40, 23), seed=11)
    x[1, 4, :] = 0.0
    x[2, :, 5] = 0.0
    k = x.shape[2] if axis == 1 else x.shape[1]
    kp = P_rec.padded_k(k)
    fn = P.split_f64 if axis == 1 else P.split_f64_cols
    got_d, got_p = fn(torch.from_numpy(x), ns, b, kp)
    for i in range(3):
        want_d, want_p = _jax_planes(x[i], ns, b, axis)
        np.testing.assert_array_equal(got_d[:, i].numpy(), _k_major_np(want_d, axis, kp))
        np.testing.assert_array_equal(got_p[i].numpy(), want_p)


@pytest.mark.parametrize("j0,j1", [(0, 16), (3, 40), (17, 64)])
def test_column_panel_through_its_stride(j0, j1):
    """A column panel b[:, j0:j1] (a strided view, as the chunked engine
    passes it) splits to the JAX planes of the contiguous panel."""
    bm = generate_input("exp_rand-8", (777, 64), seed=12)
    view = torch.from_numpy(bm)[:, j0:j1]
    assert not view.is_contiguous()
    kp = P_rec.padded_k(777)
    np.testing.assert_array_equal(P.row_exponent(view, 0).numpy(),
                                  np.asarray(R.row_exponent(F64X.from_numpy(bm[:, j0:j1].copy()), 0)))
    got_d, got_p = P.split_f64_cols(view, 9, bits_per_int8(777), kp)
    want_d, want_p = _jax_planes(bm[:, j0:j1], 9, bits_per_int8(777), 0)
    np.testing.assert_array_equal(got_d.numpy(), _k_major_np(want_d, 0, kp))
    np.testing.assert_array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("name", ["normal01", "exp_rand-8", "special"])
def test_row_exponent_equals_jax(name):
    """The plain row_exponent (and the dispatch on a CPU tensor) == the JAX
    row_exponent, by rows and by columns, 2-D and batched."""
    x = _matrix(name, (33, 47), seed=13)
    xt = torch.from_numpy(x)
    for axis in (0, 1):
        want = np.asarray(R.row_exponent(F64X.from_numpy(x), axis))
        np.testing.assert_array_equal(P.row_exponent_plain(xt, axis).numpy(), want)
        np.testing.assert_array_equal(P.row_exponent(xt, axis).numpy(), want)
    xb = np.stack([_matrix(name, (33, 47), seed=s) for s in (14, 15)])
    for axis in (0, 1):
        got = P.row_exponent(torch.from_numpy(xb), axis).numpy()
        for i in range(2):
            np.testing.assert_array_equal(got[i], np.asarray(R.row_exponent(F64X.from_numpy(xb[i]),
                                                                            axis)))


def _eq_triple(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.uint32), np.asarray(w).view(np.uint32))


@pytest.mark.parametrize("ns", [3, 9, 18])
@pytest.mark.parametrize("k", [15, 16, 17, 777])
def test_recombine_on_k_major_planes(k, ns):
    """Plain recombine on k-major planes (B [ns, n, k_pad]) == plain
    recombine on [ns, k, n] == ozimmu_tpu's recombine, on all three f32
    planes bitwise; also group_totals' int32 totals."""
    m, n = 13, 9
    b = bits_per_int8(k)
    a = generate_input("normal01", (m, k), seed=k + ns)
    bm = generate_input("exp_rand-8", (k, n), seed=k + ns + 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(bm)
    kp = P_rec.padded_k(k)
    da, _ = P.split_f64(ta, ns, b)
    db, _ = P.split_f64_cols(tb, ns, b)
    dak, _ = P.split_f64(ta, ns, b, kp)
    dbk, _ = P.split_f64_cols(tb, ns, b, kp)
    assert dbk.shape == (ns, n, kp)
    kmajor = P_rec.recombine(dak, dbk, ns, b, k, b_kmajor=True)
    _eq_triple(kmajor, P_rec.recombine(da, db, ns, b, k))
    _eq_triple(kmajor, RR.recombine(jnp.asarray(da.numpy()), jnp.asarray(db.numpy()), ns, b, k))
    for t1, t2 in zip(P_rec.group_totals(dak, dbk, ns, k, b, b_kmajor=True),
                      P_rec.group_totals(da, db, ns, k, b)):
        assert torch.equal(t1, t2)


def test_recombine_on_a_k_major_batch():
    """A batch of k-major planes == each matrix's [ns, k, n] recombine."""
    k, ns = 37, 9
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("normal01", (3, 11, k), seed=1))
    bm = torch.from_numpy(generate_input("exp_rand-8", (3, k, 7), seed=2))
    kp = P_rec.padded_k(k)
    got = P_rec.recombine(P.split_f64(a, ns, b, kp)[0], P.split_f64_cols(bm, ns, b, kp)[0],
                          ns, b, k, b_kmajor=True)
    for i in range(3):
        want = P_rec.recombine(P.split_f64(a[i], ns, b)[0], P.split_f64_cols(bm[i], ns, b)[0],
                               ns, b, k)
        _eq_triple([g[i] for g in got], want)


def test_k_major_check_raises_instead_of_copying():
    """The wrapper's check passes contiguous, 16-byte aligned planes padded
    to k_pad through as they are, and raises on anything else."""
    good = torch.zeros((9, 2, 5, 32), dtype=torch.int8)
    if good.data_ptr() % 16:
        good = torch.zeros((9 * 2 * 5 * 32 + 16,), dtype=torch.int8)[
            (-good.data_ptr()) % 16:][:9 * 2 * 5 * 32].view(9, 2, 5, 32)
    assert good.data_ptr() % 16 == 0
    assert recombine_cuda._k_major(good, 32, "B") is good
    with pytest.raises(ValueError, match="padded"):
        recombine_cuda._k_major(good[..., :31], 31 + 1, "B")  # unpadded (and strided)
    with pytest.raises(ValueError, match="padded"):
        recombine_cuda._k_major(good, 48, "A")  # padded to another k_pad
    with pytest.raises(ValueError, match="padded"):
        recombine_cuda._k_major(good.transpose(2, 3).contiguous().transpose(2, 3), 32, "B")
    flat = torch.zeros((9 * 2 * 5 * 32 + 32,), dtype=torch.int8)
    off = (-flat.data_ptr()) % 16 + 1  # one byte past a 16-byte boundary
    misaligned = flat[off:off + 9 * 2 * 5 * 32].view(9, 2, 5, 32)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 1
    with pytest.raises(ValueError, match="aligned"):
        recombine_cuda._k_major(misaligned, 32, "A")


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("batch,rows,cols", [(1, 8192, 8192), (8, 1024, 1024), (64, 256, 256),
                                             (5, 1000, 777), (1, 1, 1), (1, 15, 17),
                                             (3, 777, 64)])
@pytest.mark.parametrize("ns", [3, 9, 18])
def test_split_plan(batch, rows, cols, axis, ns):
    """The split kernel's launch: B k-major through shared-memory tiles that
    cover every (column, k_pad) of every matrix, in at most 232,448 bytes;
    every other layout row-wise, 16 elements a thread (16-byte stores)
    where the output row length allows and 1 otherwise, 16-byte loads only
    on aligned operands."""
    k = cols if axis == 1 else rows
    kp = P_rec.padded_k(k)
    for k_pad in (None, kp):
        for aligned in (True, False):
            p = split_cuda.split_plan(batch, rows, cols, axis, ns, k_pad, aligned, sms=132)
            assert p.threads == split_cuda.THREADS
            if k_pad is not None and axis == 0:
                t = split_cuda.TILE
                assert p.layout == "tiles" and p.out_cols == kp and p.vec == 16
                assert p.grid == batch * -(-cols // t) * -(-kp // t)
                assert p.smem_bytes == ns * t * split_cuda.TILE_WORDS * 4 <= 232_448
                assert p.load16 == aligned
            else:
                assert p.layout == "rows" and p.smem_bytes == 0
                assert p.out_cols == (cols if k_pad is None else kp)
                assert p.vec == (16 if p.out_cols % 16 == 0 else 1)
                assert p.load16 == (aligned and p.vec > 1)
                chunks = batch * rows * (p.out_cols // p.vec)
                assert 1 <= p.grid <= min(-(-chunks // p.threads), 132 * split_cuda.BLOCKS_PER_SM)
    with pytest.raises(ValueError, match="multiple of 16"):
        split_cuda.split_plan(batch, rows, cols, axis, ns, kp + 1, True, sms=132)
    with pytest.raises(ValueError, match="multiple of 16"):
        split_cuda.split_plan(batch, rows, cols, axis, ns, kp - 16, True, sms=132)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("batch,rows,cols", [(1, 8192, 8192), (8, 1024, 1024), (64, 256, 256),
                                             (1, 1, 1), (2, 300, 17), (1, 1024, 15360)])
def test_exponent_plan(batch, rows, cols, axis):
    """The exponent kernel's launch: a warp per row (grid-stride) or a block
    per strip of 64 (aligned) or 32 columns and slab of rows, covering
    every column of every matrix."""
    for aligned in (True, False):
        p = exponent_cuda.exponent_plan(batch, rows, cols, axis, aligned, sms=132)
        assert p.load16 == aligned and p.threads == 256
        if axis == 1:
            assert 1 <= p.grid <= min(-(-batch * rows // 8), 132 * exponent_cuda.BLOCKS_PER_SM)
        else:
            assert p.strip == (64 if aligned else 32) and p.slab == exponent_cuda.SLAB
            assert p.grid == batch * -(-cols // p.strip) * -(-rows // p.slab)
    with pytest.raises(ValueError):
        exponent_cuda.exponent_plan(1, 0, 5, axis, True, sms=132)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        exponent_cuda.exponent_max(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        split_cuda.split_digits(x, torch.zeros(4, dtype=torch.int32), 9, 7, 1, 16)


def _recording(monkeypatch):
    """Wrap the engine's split and recombine to record what they hand on."""
    seen = {"split": [], "recombine": []}
    for name in ("split_f64", "split_f64_cols"):
        real = getattr(core, name)

        def rec(x, ns, b, k_pad=None, _real=real, _name=name):
            d, p = _real(x, ns, b, k_pad)
            seen["split"].append((_name, tuple(x.shape), x.is_contiguous(), k_pad, d))
            return d, p
        monkeypatch.setattr(core, name, rec)
    real_rec = core.recombine

    def rec_r(da, db, ns, b, k, b_kmajor=False):
        seen["recombine"].append((da, db, b_kmajor))
        return real_rec(da, db, ns, b, k, b_kmajor)
    monkeypatch.setattr(core, "recombine", rec_r)
    return seen


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_engine_hands_recombine_the_split_planes(monkeypatch, n_chunks):
    """gemm_f64 splits A and B straight into k-major planes padded to
    padded_k(k), each B panel where it lies in b (no contiguous copy), and
    recombine gets those very tensors with b_kmajor; the result is that of
    the JAX package's engine path (its parity tests) and unchanged by the
    chunking."""
    m, k, n = 21, 37, 30
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=1))
    bm = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=2))
    want = core.gemm_f64(a, bm, 9, n_chunks=1)
    seen = _recording(monkeypatch)
    got = core.gemm_f64(a, bm, 9, n_chunks=n_chunks)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    kp = P_rec.padded_k(k)
    splits_b = [s for s in seen["split"] if s[0] == "split_f64_cols"]
    assert len(splits_b) == n_chunks and all(s[3] == kp for s in seen["split"])
    assert all(s[2] == (n_chunks == 1) for s in splits_b)  # panels stay strided views
    assert len(seen["recombine"]) == n_chunks
    for (da, db, kmajor), s in zip(seen["recombine"], splits_b):
        assert kmajor and db is s[4] and db.shape[-1] == kp and da.shape == (9, m, kp)


def test_zgemm_lays_out_each_b_part_once(monkeypatch):
    """The complex engine splits each B part once (k-major) and its four
    passes read those planes as they are: two B splits, four recombines,
    each B tensor handed to two passes."""
    m, k, n = 12, 21, 10
    rng = np.random.default_rng(7)
    parts = [torch.from_numpy(rng.standard_normal(s)) for s in ((m, k), (m, k), (k, n), (k, n))]
    seen = _recording(monkeypatch)
    core.zgemm_f64(*parts, 9, n_chunks=1)
    b_planes = [s[4] for s in seen["split"] if s[0] == "split_f64_cols"]
    assert len(b_planes) == 2 and len(seen["recombine"]) == 4
    for plane in b_planes:
        assert sum(db is plane for _, db, _ in seen["recombine"]) == 2
    assert all(kmajor for _, _, kmajor in seen["recombine"])


@pytest.mark.parametrize("m,n,k,ns", [(48, 40, 32, 9), (33, 17, 64, 18), (16, 64, 256, 3)])
def test_working_set_plane_term_equals_the_split_bytes(monkeypatch, m, n, k, ns):
    """At k a multiple of 16 (no padding), the working-set model's plane
    term, ns * (m*k + k*n), is the bytes of the planes the engine's split
    allocates (B's once: no transposed copy), unchunked and per panel."""
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=3))
    bm = torch.from_numpy(generate_input("normal01", (k, n), seed=4))
    seen = _recording(monkeypatch)
    core.gemm_f64(a, bm, ns, n_chunks=1)
    assert sum(s[4].numel() for s in seen["split"]) == ns * (m * k + k * n)
    model = schedule.working_set_bytes(m, n, k, ns)
    assert model - ns * (m * k + k * n) == schedule.working_set_bytes(m, n, k, ns) - sum(
        s[4].numel() for s in seen["split"])
    seen["split"].clear()
    core.gemm_f64(a, bm, ns, n_chunks=4)
    w = -(-n // 4)
    assert seen["split"][0][4].numel() == ns * m * k  # resident: A's planes
    assert max(s[4].numel() for s in seen["split"][1:]) == ns * k * w  # per panel: B's
