"""The CUDA kernels against their plain PyTorch versions, bitwise, on the
GPU.  Marked ``cuda``: without a GPU every test here skips.  Run on the
GPU machine with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports jax, which that machine need not have)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu_torch.ops import recombine as R  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda, split_cuda  # noqa: E402
from ozimmu_tpu_torch.ops import split as S  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

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
    before = (split_cuda.LAUNCHES, recombine_cuda.LAUNCHES)
    gpu = [t.to(dev) for t in cpu]
    got = ozt.zgemm_f64(*gpu[:4], ns, c_re=gpu[4], c_im=gpu[5], **kw)
    assert (split_cuda.LAUNCHES - before[0], recombine_cuda.LAUNCHES - before[1]) == (4, 4)
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
    got = ozt.gemm_batched(a.to(dev), b.to(dev), c=c.to(dev), **kw)
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
