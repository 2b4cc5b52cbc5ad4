"""The CUDA kernels against their plain PyTorch versions, bitwise, on the
GPU.  Marked ``cuda``: without a GPU every test here skips.  Run on the
GPU machine with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports jax, which that machine need not have)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as R  # noqa: E402
from ozimmu_tpu_torch.ops import epilogue_cuda, exponent_cuda, recombine_cuda, split_cuda  # noqa: E402
from ozimmu_tpu_torch.ops import split as S  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import crafted_exponents, crafted_triples, generate_input  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _special():
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, 5] = -1e-300
    return x


@pytest.mark.parametrize("name", ["normal01", "exp_rand-8", "special"])
@pytest.mark.parametrize("ns,b", [(3, 7), (9, 7), (18, 7), (3, 5), (9, 5), (18, 5)])
def test_split_kernel_equals_plain(dev, name, ns, b):
    x_np = _special() if name == "special" else generate_input(name, (1000, 1234), seed=1)
    x = torch.from_numpy(x_np).to(dev)
    for axis in (0, 1):
        e = S.row_exponent(x, axis)
        want, _ = S.split_with_row_exp(x, e, ns, b, axis)
        got = split_cuda.split_digits(x, e, ns, b, axis)
        assert torch.equal(want, got), (name, ns, b, axis)


def _operands(dev):
    """2-D operands (k off the multiple of 16 among them), a batch with a
    zero row, a zero column and a subnormal, and column panels whose rows
    are strided views, 16-byte aligned or not."""
    xb = generate_input("exp_rand-8", (3, 300, 777), seed=4)
    xb[0, 5, :] = 0.0
    xb[1, :, 7] = 0.0
    xb[2, 3, 3] = 5e-324
    wide = torch.from_numpy(generate_input("normal01", (1000, 1234), seed=1)).to(dev)
    ops = {"special": torch.from_numpy(_special()).to(dev),
           "exp_rand-8(1000x1234)": torch.from_numpy(
               generate_input("exp_rand-8", (1000, 1234), seed=2)).to(dev),
           "batch(3x300x777)": torch.from_numpy(xb).to(dev),
           "panel[:, 3:700]": wide[:, 3:700], "panel[:, 64:1000]": wide[:, 64:1000]}
    for k in (1, 15, 16, 17):
        ops[f"{k}x129"] = torch.from_numpy(generate_input("normal01", (k, 129), seed=k)).to(dev)
        ops[f"129x{k}"] = torch.from_numpy(generate_input("normal01", (129, k), seed=k)).to(dev)
    return ops


def test_exponent_kernel_equals_plain(dev):
    """The exponent-max kernel == torch.amax of the exponent field, by rows
    and by columns, 2-D, batched and through a panel's strides, one launch
    each."""
    for name, x in _operands(dev).items():
        for axis in (0, 1):
            before = exponent_cuda.LAUNCHES
            got = exponent_cuda.exponent_max(x, axis)
            assert exponent_cuda.LAUNCHES - before == 1
            assert got.dtype == torch.int32
            assert torch.equal(got, S.row_exponent_plain(x, axis)), (name, axis)
            assert torch.equal(S.row_exponent(x, axis), got), (name, axis)


@pytest.mark.parametrize("ns,b", [(3, 7), (9, 5), (18, 7), (9, 7)])
def test_split_kernel_k_major_equals_plain(dev, ns, b):
    """Both layouts of the split kernel (natural, and k-major padded to the
    next multiple of 16 and to 16 more) == the plain split, 2-D, batched,
    through a panel's strides and at k around the multiple of 16."""
    for name, x in _operands(dev).items():
        for axis in (0, 1):
            e = S.row_exponent_plain(x, axis)
            k = x.shape[-1] if axis == 1 else x.shape[-2]
            for kp in (None, R.padded_k(k), R.padded_k(k) + 16):
                want, _ = S.split_with_row_exp(x, e, ns, b, axis, kp)
                got = split_cuda.split_digits(x, e, ns, b, axis, kp)
                assert torch.equal(want, got), (name, axis, kp)


@pytest.mark.parametrize("m,n,k,ns", [(200, 136, 272, 6), (1000, 1234, 777, 9), (17, 9, 32, 3),
                                      (130, 260, 4096, 18)])
def test_recombine_reads_k_major_planes(dev, m, n, k, ns):
    """recombine on the engine's k-major planes (no copy) == recombine on
    [ns, k, n] planes (the transposed copy) == the plain version, in every
    tile class; planes that are not padded to the plan's k_pad raise."""
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=m)).to(dev)
    bm = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=n)).to(dev)
    kp = R.padded_k(k)
    da, _ = S.split_f64(a, ns, b, kp)
    db, _ = S.split_f64_cols(bm, ns, b, kp)
    want = R.fold_group_totals(R.group_totals(da, db, ns, k, b, b_kmajor=True), ns, k, b)
    old = recombine_cuda.recombine(S.split_f64(a, ns, b)[0], S.split_f64_cols(bm, ns, b)[0],
                                   ns, b, k)
    for tile in [None, *range(len(recombine_cuda.TILES))]:
        got = recombine_cuda.recombine(da, db, ns, b, k, tile=tile, b_kmajor=True)
        for w, g, o in zip(want, got, old):
            assert torch.equal(w.view(torch.int32), g.view(torch.int32)), tile
            assert torch.equal(o.view(torch.int32), g.view(torch.int32)), tile
    if k % 16:
        with pytest.raises(ValueError):
            recombine_cuda.recombine(da[..., :k].contiguous(), db[..., :k].contiguous(), ns, b, k,
                                     b_kmajor=True)


def _counters():
    return (split_cuda.LAUNCHES, exponent_cuda.LAUNCHES, recombine_cuda.LAUNCHES,
            epilogue_cuda.LAUNCHES, epilogue_cuda.ZFOLD_LAUNCHES)


def _launched(before):
    torch.cuda.synchronize()
    return tuple(x - y for x, y in zip(_counters(), before))


def test_gemm_launches_exponent_split_and_recombine(dev):
    """One real GEMM launches the exponent max and the split twice each,
    recombine and the epilogue once; a column-chunked one once per B panel
    more (each panel's epilogue writing its columns in place)."""
    import ozimmu_tpu_torch as ozt

    a = torch.from_numpy(generate_input("normal01", (300, 777), seed=5)).to(dev)
    b = torch.from_numpy(generate_input("exp_rand-8", (777, 260), seed=6)).to(dev)
    c = torch.from_numpy(generate_input("normal01", (300, 260), seed=7)).to(dev)
    for chunks in (1, 3):
        torch.cuda.synchronize()
        before = _counters()
        got = ozt.gemm_f64(a, b, 9, alpha=-1.0, beta=1.0, c=c, n_chunks=chunks)
        assert _launched(before) == (1 + chunks, 1 + chunks, chunks, chunks, 0)
        want = ozt.gemm_f64(a.cpu(), b.cpu(), 9, alpha=-1.0, beta=1.0, c=c.cpu(),
                            n_chunks=chunks)
        assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize(
    "m,n,k,ns",
    [(200, 136, 272, 6), (256, 128, 1024, 8), (1000, 1234, 777, 9), (64, 64, 16384, 9),
     (17, 9, 32, 3), (1025, 1023, 1025, 16), (130, 260, 4096, 18), (512, 640, 32768, 12),
     (3072, 3072, 256, 9), (15360, 15360, 1024, 9), (1024, 15360, 1024, 9),
     (7168, 7168, 1024, 9), (1024, 7168, 1024, 9)],
)
def test_recombine_kernel_equals_plain(dev, m, n, k, ns):
    """Bitwise on all three planes, in every tile class: ragged edges,
    k % 16 != 0 (zero-padded k), 171 pairs at ns = 18, int32 group splits
    at k = 16384 and 32768, and the solvers' products (short k under a wide
    m x n): a block of 256, and the first trailing update and U12 product
    of HPL at n = 16384 and ZHPL at n = 8192 with block 1024."""
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=m)).to(dev)
    bm = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=n)).to(dev)
    da, _ = S.split_f64(a, ns, b)
    db, _ = S.split_f64_cols(bm, ns, b)
    want = R.fold_group_totals(R.group_totals(da, db, ns, k, b), ns, k, b)
    for tile in [None, *range(len(recombine_cuda.TILES))]:
        got = recombine_cuda.recombine(da, db, ns, b, k, tile=tile)
        for w, g in zip(want, got):
            assert torch.equal(w.view(torch.int32), g.view(torch.int32)), tile


@pytest.mark.parametrize("ns,b", [(3, 7), (9, 5), (18, 5)])
def test_split_kernel_on_a_batch_equals_plain(dev, ns, b):
    """One launch over [3, 1000, 777] (each matrix against its own row or
    column exponents) equals the plain split of the batch and the 2-D
    kernel of each matrix."""
    x_np = generate_input("exp_rand-8", (3, 1000, 777), seed=2)
    x_np[0, 5, :] = 0.0
    x_np[1, :, 7] = 0.0
    x_np[2, 3, 3] = 5e-324
    x = torch.from_numpy(x_np).to(dev)
    for axis in (0, 1):
        e = S.row_exponent(x, axis)
        want, _ = S.split_with_row_exp(x, e, ns, b, axis)
        before = split_cuda.LAUNCHES
        got = split_cuda.split_digits(x, e, ns, b, axis)
        assert split_cuda.LAUNCHES - before == 1
        assert torch.equal(want, got), (ns, b, axis)
        for i in range(3):
            assert torch.equal(got[:, i], split_cuda.split_digits(x[i], e[i].contiguous(), ns, b,
                                                                  axis)), (axis, i)


@pytest.mark.parametrize("bsz,m,n,k,ns", [(5, 1000, 513, 777, 9), (3, 17, 9, 32, 3),
                                          (4, 130, 260, 4096, 18), (64, 256, 256, 256, 9),
                                          (2, 1025, 1023, 1025, 16)])
def test_recombine_kernel_on_a_batch_equals_plain(dev, bsz, m, n, k, ns):
    """One launch over the batch, bitwise on all three planes in every
    tile class, equal to the plain version matrix by matrix: m and n off
    every tile size, so that a tile reaching past a matrix's last row
    reads zeros and not the next matrix's rows."""
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("normal01", (bsz, m, k), seed=m)).to(dev)
    bm = torch.from_numpy(generate_input("exp_rand-8", (bsz, k, n), seed=n)).to(dev)
    da, _ = S.split_f64(a, ns, b)
    db, _ = S.split_f64_cols(bm, ns, b)
    want = R.fold_group_totals(R.group_totals(da, db, ns, k, b), ns, k, b)
    for tile in [None, *range(len(recombine_cuda.TILES))]:
        before = recombine_cuda.LAUNCHES
        got = recombine_cuda.recombine(da, db, ns, b, k, tile=tile)
        assert recombine_cuda.LAUNCHES - before == 1
        for w, g in zip(want, got):
            assert torch.equal(w.view(torch.int32), g.view(torch.int32)), tile


@pytest.mark.parametrize("m,n,k,ns", [(200, 136, 272, 6), (1000, 1234, 777, 9), (256, 128, 1024, 18)])
def test_zgemm_on_the_kernels_equals_plain(dev, m, n, k, ns):
    """The 4-pass complex engine through both kernels against the same
    engine on the CPU, where it runs the plain versions."""
    import ozimmu_tpu_torch as ozt

    rng = np.random.default_rng(k)
    planes = [rng.standard_normal(s) for s in ((m, k), (m, k), (k, n), (k, n), (m, n), (m, n))]
    kw = dict(alpha=2 - 0.5j, beta=0.25 + 1j)
    cpu = [torch.from_numpy(p) for p in planes]
    want = ozt.zgemm_f64(*cpu[:4], ns, c_re=cpu[4], c_im=cpu[5], **kw)
    gpu = [t.to(dev) for t in cpu]
    before = _counters()
    got = ozt.zgemm_f64(*gpu[:4], ns, c_re=gpu[4], c_im=gpu[5], **kw)
    assert _launched(before) == (4, 4, 4, 0, 1)
    for w, g in zip(want, got):
        assert torch.equal(w.view(torch.int64), g.cpu().view(torch.int64))


@pytest.mark.parametrize("name", ["normal01", "exp_rand-8", "special"])
def test_auto_totals_histogram_equals_literal(dev, name):
    from ozimmu_tpu_torch.core.bits import exponent_field
    from ozimmu_tpu_torch.ops.mantissa_loss import mantissa_loss_totals
    from ozimmu_tpu_torch.testing import loss_totals_literal

    x_np = _special() if name == "special" else generate_input(name, (1000, 1234), seed=1)
    x = torch.from_numpy(x_np).to(dev)
    for axis in (0, 1):
        e = torch.amax(exponent_field(x), dim=axis)
        for b in (7, 5):
            got = mantissa_loss_totals(x, b, axis)
            assert torch.equal(got, loss_totals_literal(x, e, b, axis)), (name, axis, b)
            assert torch.equal(got.cpu(), mantissa_loss_totals(x.cpu(), b, axis))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_batched_equals_a_loop_and_plain(dev, kind):
    import ozimmu_tpu_torch as ozt

    cx = kind == "complex"
    a = torch.from_numpy(generate_input("normal01", (3, 200, 272), seed=5, complex_=cx))
    b = torch.from_numpy(generate_input("exp_rand-8", (3, 272, 136), seed=6, complex_=cx))
    c = torch.from_numpy(generate_input("normal01", (3, 200, 136), seed=7, complex_=cx))
    kw = dict(mode="fp64_int8_9", alpha=1.5, beta=-0.5)
    torch.cuda.synchronize()
    before = _counters()
    got = ozt.gemm_batched(a.to(dev), b.to(dev), c=c.to(dev), **kw)
    launches = _launched(before)  # for the whole batch, the fold over its [B*m, n] view
    assert launches == ((4, 4, 4, 0, 1) if cx else (2, 2, 1, 1, 0)), launches
    as_real = torch.view_as_real if cx else (lambda t: t)
    want = ozt.gemm_batched(a, b, c=c, **kw)
    assert torch.equal(as_real(got.cpu()).view(torch.int64), as_real(want).view(torch.int64))
    for i in range(3):
        one = ozt.gemm(a[i].to(dev), b[i].to(dev), c=c[i].to(dev), **kw)
        assert torch.equal(as_real(got[i]).view(torch.int64), as_real(one).view(torch.int64))


def test_intercepted_product_runs_the_kernels(dev):
    """An intercepted 1024^3 float64 product equals ``ozt.gemm`` bitwise and
    launches split twice and recombine once."""
    import ozimmu_tpu_torch as ozt
    import ozimmu_tpu_torch.intercept as ozi

    a = torch.from_numpy(generate_input("urand01", (1024, 1024), seed=80)).to(dev)
    b = torch.from_numpy(generate_input("urand01", (1024, 1024), seed=81)).to(dev)
    want = ozt.gemm(a, b, mode="fp64_int8_9")
    torch.cuda.synchronize()
    before = (split_cuda.LAUNCHES, recombine_cuda.LAUNCHES)
    with ozi.intercept(mode="fp64_int8_9"):
        got = a @ b
    torch.cuda.synchronize()
    assert (split_cuda.LAUNCHES - before[0], recombine_cuda.LAUNCHES - before[1]) == (2, 1)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def test_compiled_traced_gemm_equals_eager(dev):
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import traced

    a, b, c = (torch.from_numpy(generate_input("normal01", s, seed=90 + i)).to(dev)
               for i, s in enumerate([(300, 520), (520, 260), (300, 260)]))
    f = torch.compile(lambda x, y, z: traced.gemm(x, y, alpha=2.0, beta=-0.5, c=z), fullgraph=True)
    got = f(a, b, c)
    want = ozt.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=-0.5, c=c)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("kind", ["lu", "lu_device_panels", "zlu", "cholesky"])
def test_resident_factorizations_equal_the_cpu_runs(dev, kind):
    """n = 512, block 128 (k % 16 != 0 at block 100 for the real LU): with
    host panels every device step is exact engine arithmetic around the
    same LAPACK calls, so the factor on the card equals the CPU run's (the
    plain versions) bit for bit; with device panels the pivots are equal
    and the factorization meets the 1e-14 gate."""
    from ozimmu_tpu_torch import linalg

    n = 512
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (n, n))
    if kind == "zlu":
        a = a + 1j * rng.uniform(-1, 1, (n, n))
    if kind == "cholesky":
        a = a @ a.T + n * np.eye(n)
    cpu = torch.from_numpy(a)
    as_real = torch.view_as_real if kind == "zlu" else (lambda t: t)
    before = (split_cuda.LAUNCHES, recombine_cuda.LAUNCHES)
    if kind == "cholesky":
        got = linalg.cholesky(cpu.to(dev), mode="fp64_int8_9", block=128)
        want = linalg.cholesky(cpu, mode="fp64_int8_9", block=128)
        steps, per_step = 3, (4, 2)
    else:
        block = 100 if kind == "lu" else 128
        panel = "device" if kind == "lu_device_panels" else "host"
        got, piv = linalg.lu_factor(cpu.to(dev), mode="fp64_int8_9", block=block, panel=panel)
        want, piv_cpu = linalg.lu_factor(cpu, mode="fp64_int8_9", block=block)
        np.testing.assert_array_equal(piv, piv_cpu)
        steps, per_step = -(-n // block) - 1, ((8, 8) if kind == "zlu" else (4, 2))
    torch.cuda.synchronize()
    assert (split_cuda.LAUNCHES - before[0], recombine_cuda.LAUNCHES - before[1]) == (
        steps * per_step[0], steps * per_step[1])
    if kind == "lu_device_panels":
        lu = got.cpu().numpy()
        pa = a.copy()
        for i in range(n):
            pa[[i, piv[i]]] = pa[[piv[i], i]]
        assert np.linalg.norm(pa - (np.tril(lu, -1) + np.eye(n)) @ np.triu(lu)) / np.linalg.norm(
            a) < 1e-14
    else:
        assert torch.equal(as_real(got.cpu()).view(torch.int64), as_real(want).view(torch.int64))


@pytest.mark.parametrize("mesh,nproc,backend", [("1x1", 1, "nccl"), ("2x2", 4, "gloo")])
def test_distributed_layer_on_the_card_equals_gemm(dev, mesh, nproc, backend):
    """The 2x2 wrapper cases of tests/torch_parallel_cases.py (SUMMA, ring,
    stream, k-sharded through AUTO, real and complex, alpha / beta / c,
    padded), run by ranks on the card (one over NCCL, or four sharing it
    over gloo), equal the one-device gemm on CPU tensors bit for bit."""
    import os

    import torch_parallel_cases as cases
    from ozimmu_tpu_torch.parallel import local

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_cases.py")
    ranks = local.run(f"{path}:CASES_CARD", mesh, nproc=nproc, device="cuda", backend=backend,
                      timeout=600)
    for name, s in cases.SPECS_2x2.items():
        errors = [str(r[f"{name}/error"]) for r in ranks if f"{name}/error" in r]
        assert not errors, errors[0]
        if s["local"] == "bits":
            got = np.ascontiguousarray(ranks[0][f"{name}/out"])
            want = np.ascontiguousarray(cases.run_local(s))
            assert np.array_equal(got.view(np.uint64), want.view(np.uint64)), name


@pytest.mark.parametrize("mesh,nproc,backend", [("1x1", 1, "nccl"), ("4x1", 4, "gloo")])
def test_sharded_solvers_on_the_card_equal_one_device(dev, mesh, nproc, backend):
    """The factorizations of tests/torch_linalg_mesh_cases.py row-sharded by
    ranks on the card (one over NCCL, or four sharing it over gloo) against
    the one-device call on the card: host panels and Cholesky bit for bit,
    device panels with the same pivots and within 1e-13."""
    import os

    import torch_linalg_mesh_cases as cases
    from ozimmu_tpu_torch.parallel import local

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_linalg_mesh_cases.py")
    ranks = local.run(f"{path}:CASES_CARD", mesh, nproc=nproc, device="cuda", backend=backend,
                      timeout=600)
    for name, (_, _, _, _, panel, _) in cases.SPECS.items():
        for r in ranks:
            assert f"{name}/error" not in r, str(r[f"{name}/error"])
            assert bool(r[f"{name}/same_piv"]), name
            if panel == "device":
                assert float(r[f"{name}/rel"]) < 1e-13, name
            else:
                assert bool(r[f"{name}/same_bits"]), name


#: the epilogue's branches (alpha != 1, beta != 0, beta != 1), alpha = 0
#: and scalars whose triples use all three components among them
EPILOGUE_BRANCHES = [(1.0, 0.0), (-1.5, 0.0), (1.0, 1.0), (-1.0, 1.0), (1.0, -0.5),
                     (2.5, -0.5), (0.0, 1.5), (0.1, 1.0 / 3.0)]


def _recombined(dev, seed: int, m: int = 300, k: int = 777, n: int = 260):
    """(S, Exponents) of a real engine product on the card and a c of its
    shape."""
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=seed)).to(dev)
    b = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=seed + 1)).to(dev)
    bb = bits_per_int8(k)
    da, pa = S.split_f64(a, 9, bb)
    db, pb = S.split_f64_cols(b, 9, bb)
    SE = (R.recombine(da, db, 9, bb, k), core.Exponents(pa, pb, R.acc_shift(9, bb)))
    return SE, torch.from_numpy(generate_input("normal01", (m, n), seed=seed + 2)).to(dev)


def _window(c: torch.Tensor) -> torch.Tensor:
    """``c`` as a strided window of a wider matrix (as HPL passes its own)."""
    m, n = c.shape
    wide = torch.zeros((m + 3, n + 7), dtype=c.dtype, device=c.device)
    wide[3:, 5:5 + n] = c
    return wide[3:, 5:5 + n]


def _bits_equal(x, y) -> bool:
    return x.shape == y.shape and torch.equal(x.cpu().view(torch.int64), y.cpu().view(torch.int64))


def _plane(E):
    return E.plane() if isinstance(E, core.Exponents) else E


@pytest.mark.parametrize("alpha,beta", EPILOGUE_BRANCHES)
@pytest.mark.parametrize("inputs", ["recombine", "recombine-plane", "crafted", "crafted-parts"])
def test_epilogue_kernel_equals_plain(dev, inputs, alpha, beta):
    """The epilogue kernel == the plain ``_epilogue_block`` on the card and
    on the CPU, bit for bit, with the exponents as parts (formed in the
    kernel) and as a plane (the sgemm route), for c contiguous and as a
    strided window, and written into a column panel of a wider output; one
    launch each."""
    if inputs.startswith("recombine"):
        (Sd, E), c = _recombined(dev, seed=30)
    else:
        Sd, E, c = crafted_triples(203, 131, seed=31, device=dev)
        if inputs == "crafted-parts":
            E = core.Exponents(*crafted_exponents(203, 131, seed=32, device=dev))
    if inputs.endswith("plane"):
        E = _plane(E)
    m, n = Sd[0].shape
    Ep = _plane(E)
    for cw in (c, _window(c)):
        cb = cw if beta != 0.0 else None
        want = core._epilogue_block(Sd, Ep, alpha, beta, cb)
        want_cpu = core._epilogue_block(tuple(t.cpu() for t in Sd), Ep.cpu(), alpha, beta,
                                        None if cb is None else cb.cpu())
        before = _counters()
        got = epilogue_cuda.epilogue(Sd, E, alpha, beta, cb)
        assert _launched(before) == (0, 0, 0, 1, 0)
        assert _bits_equal(got, want) and _bits_equal(got, want_cpu), (inputs, alpha, beta)
        wide = torch.full((m, n + 9), 7.0, dtype=torch.float64, device=dev)
        assert core._epilogue_SE(Sd, E, alpha, beta, cb, wide[:, 4:4 + n]).data_ptr() == \
            wide[:, 4:].data_ptr()
        assert _bits_equal(wide[:, 4:4 + n], want)
        assert bool((wide[:, :4] == 7.0).all() and (wide[:, 4 + n:] == 7.0).all())


#: the launch plan's layouts: (m, n, output column offset in a wider
#: matrix, c's pad) — odd n through the one-column tail, n % 4 == 2, a
#: column panel at an odd offset (vector loads, one-double stores), an
#: aligned panel, c contiguous or a window at an odd column
LAYOUTS = [(1031, 1029, 0, 0), (515, 1026, 0, 3), (300, 260, 3, 0), (300, 260, 2, 5),
           (64, 4, 1, 1), (1, 1, 0, 0), (7, 3, 5, 2)]


@pytest.mark.parametrize("m,n,offset,pad", LAYOUTS)
def test_epilogue_and_fold_layouts_equal_plain(dev, m, n, offset, pad):
    """Both kernels == plain, bit for bit, in each layout of the launch
    plan, HPL's alpha = -1, beta = 1 among the branches."""
    rng = np.random.default_rng(m * n + offset)
    (Sd, E), c = _recombined(dev, seed=70 + n % 7, m=m, k=272, n=n)
    if pad:
        big = torch.zeros((m + pad, n + pad), dtype=torch.float64, device=dev)
        big[pad:, pad:] = c
        c = big[pad:, pad:]
    for alpha, beta in ((1.0, 0.0), (-1.0, 1.0), (2.5, -0.5)):
        cb = c if beta != 0.0 else None
        want = core._epilogue_block(Sd, E.plane(), alpha, beta, cb)
        wide = torch.full((m, n + offset + 3), 7.0, dtype=torch.float64, device=dev)
        before = _counters()
        core._epilogue_SE(Sd, E, alpha, beta, cb, wide[:, offset:offset + n])
        assert _launched(before) == (0, 0, 0, 1, 0)
        assert _bits_equal(wide[:, offset:offset + n], want), (m, n, offset, alpha, beta)
        assert bool((wide[:, :offset] == 7.0).all() and (wide[:, offset + n:] == 7.0).all())
    SEs = [(Sd, E)] + [_recombined(dev, seed=80 + i, m=m, k=272, n=n)[0] for i in range(3)]
    planes = [(S_, E_.plane()) for S_, E_ in SEs]
    c_im = torch.from_numpy(rng.uniform(-1, 1, (m, n))).to(dev)
    for alpha, beta in ((1.0, 0.0), (0.5 - 1.5j, 1.25 + 0.5j), (1.0, 1.0)):
        want = core._zfold_block(planes, m, n, complex(alpha), complex(beta), c, c_im, dev)
        outs = [torch.full((m, n + offset + 3), 7.0, dtype=torch.float64, device=dev)
                for _ in range(2)]
        before = _counters()
        epilogue_cuda.zfold(SEs, alpha, beta, c, c_im,
                            tuple(o[:, offset:offset + n] for o in outs))
        assert _launched(before) == (0, 0, 0, 0, 1)
        for o, w in zip(outs, want):
            assert _bits_equal(o[:, offset:offset + n], w), (m, n, offset, alpha, beta)


def test_epilogue_kernel_on_the_sgemm_route(dev):
    """``gemm(..., mode="sgemm")`` with alpha and beta folds them through
    the epilogue's E-plane route (the unpacked result has no row and
    column parts): one launch, == the plain epilogue on the same plane."""
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch.ops.pack import unpack_f64

    rng = np.random.default_rng(90)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)).to(dev)
               for s in ((257, 300), (300, 131), (257, 131)))
    before = _counters()
    got = ozt.gemm(a, b, mode="sgemm", alpha=-2.5, beta=0.75, c=c)
    assert _launched(before) == (0, 0, 0, 1, 0)
    t, E = unpack_f64(ozt.gemm(a, b, mode="sgemm"))
    assert _bits_equal(got, core._epilogue_block(t, E, -2.5, 0.75, c))


@pytest.mark.parametrize("beta", [0.0, 1.0, -1.0, 0.75, 1.25 + 0.5j])
@pytest.mark.parametrize("alpha", [0.0, 1.0, -1.0, 2.5, 0.5 - 1.5j])
@pytest.mark.parametrize("inputs", ["recombine", "crafted"])
def test_zfold_kernel_equals_plain(dev, inputs, alpha, beta):
    """The fold kernel == the plain ``_zfold_block`` on the card and on the
    CPU, bit for bit, with c absent, contiguous and as strided windows;
    crafted triples take crafted exponent parts (the kernel forms every
    exponent from pa and pb)."""
    SEs, cs = [], []
    for i in range(4):
        if inputs == "recombine":
            SE, c = _recombined(dev, seed=40 + 3 * i, m=150, k=272, n=130)
        else:
            Sd, _, c = crafted_triples(83, 61, seed=50 + i, device=dev)
            SE = (Sd, core.Exponents(*crafted_exponents(83, 61, seed=60 + i, device=dev)))
        SEs.append(SE)
        cs.append(c)
    c_re, c_im = cs[:2]
    m, n = SEs[0][0][0].shape
    planes = [(S_, E.plane()) for S_, E in SEs]
    cpu_SEs = [(tuple(t.cpu() for t in S_), E.cpu()) for S_, E in planes]
    for parts in ((None, None), (c_re, c_im), (_window(c_re), _window(c_im))):
        args = (complex(alpha), complex(beta), *parts)
        want = core._zfold_block(planes, m, n, *args, dev)
        want_cpu = core._zfold_block(cpu_SEs, m, n, *args[:2],
                                     *(None if p is None else p.cpu() for p in parts), "cpu")
        before = _counters()
        got = epilogue_cuda.zfold(SEs, *args)
        assert _launched(before) == (0, 0, 0, 0, 1)
        for g, w, wc in zip(got, want, want_cpu):
            assert _bits_equal(g, w) and _bits_equal(g, wc), (inputs, alpha, beta)


@pytest.mark.parametrize("p", [180, 200])
def test_epilogue_kernel_keeps_a_subnormal_sticky_bit_at_a_tie(dev, p):
    """tests/test_torch_gemm.py's tie on the card: beta * c alone is an
    exact half-ulp tie, and alpha * a @ b, 180-200 binades below it (an
    f32-subnormal tail inside the kernel), breaks it downward."""
    import ozimmu_tpu_torch as ozt

    a = torch.tensor([[-(2.0 ** -(p // 2))]], dtype=torch.float64, device=dev)
    b = torch.tensor([[2.0 ** -(p - p // 2)]], dtype=torch.float64, device=dev)
    c = torch.tensor([[1.0 + 2.0**-52]], dtype=torch.float64, device=dev)
    before = _counters()
    got = ozt.gemm(a, b, mode="fp64_int8_9", beta=1.5, c=c)
    assert _launched(before) == (2, 2, 1, 1, 0)
    assert float(got[0, 0]) == 1.5 + 2.0**-52 and float.hex(float(got[0, 0])) == \
        "0x1.8000000000001p+0"


def test_epilogue_kernel_over_a_batch_view(dev):
    """``_epilogue_SE`` on a batch [B, m, n] runs one launch, with the
    exponents as a batch's parts (pa [B, m], pb [B, n]; the kernel finds
    each row band's matrix) and as a plane over the [B*m, n] view, equal to
    the plain version matrix by matrix; the fold likewise on the rows."""
    bsz, m, k, n = 3, 100, 272, 132
    xa = torch.from_numpy(generate_input("normal01", (bsz, m, k), seed=60)).to(dev)
    xb = torch.from_numpy(generate_input("exp_rand-8", (bsz, k, n), seed=61)).to(dev)
    cb = torch.from_numpy(generate_input("normal01", (bsz, m, n), seed=62)).to(dev)
    bb = bits_per_int8(k)
    da, pa = S.split_f64(xa, 9, bb)
    db, pb = S.split_f64_cols(xb, 9, bb)
    Sb = R.recombine(da, db, 9, bb, k)
    Eb = core.Exponents(pa, pb, R.acc_shift(9, bb))
    for E in (Eb, Eb.plane()):
        before = _counters()
        got = core._epilogue_SE(Sb, E, 2.5, -0.5, cb)
        assert _launched(before) == (0, 0, 0, 1, 0) and got.shape == (bsz, m, n)
        for i in range(bsz):
            want = core._epilogue_block(tuple(t[i] for t in Sb), Eb.plane()[i], 2.5, -0.5, cb[i])
            assert _bits_equal(got[i], want), i
    rows = lambda x: x.reshape(bsz * m, n)  # noqa: E731
    SEs = [(tuple(map(rows, Sb)), Eb)] * 4
    before = _counters()
    got = core._zfold_passes(SEs, bsz * m, n, 0.5 - 1.5j, 1.25 + 0.5j, rows(cb), None, dev)
    assert _launched(before) == (0, 0, 0, 0, 1)
    want = core._zfold_block([(tuple(map(rows, Sb)), rows(Eb.plane()))] * 4, bsz * m, n,
                             0.5 - 1.5j, 1.25 + 0.5j, rows(cb), None, dev)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
