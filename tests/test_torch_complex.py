"""The complex engine (ZGEMM) end to end on the CPU: ``ozimmu_tpu_torch.gemm``
on complex128 returns the same f64 bits as ``ozimmu_tpu.gemm`` for every
int8 mode, op pair and alpha/beta/c tested; chunked, profiled and AUTO
runs included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import mantissa_loss as ref_ml  # noqa: E402
from ozimmu_tpu_torch.ops import mantissa_loss as port_ml  # noqa: E402
from ozimmu_tpu_torch.testing import error_metrics, generate_input  # noqa: E402

M, K, N = 33, 47, 65


def _u64(x):
    x = np.asarray(x, dtype=np.complex128)
    return np.stack([x.real, x.imag]).view(np.uint64)


def _operands(op_a="N", op_b="N", dist="normal01", seed=0):
    a = generate_input(dist, (M, K) if op_a == "N" else (K, M), seed=seed, complex_=True)
    b = generate_input(dist, (K, N) if op_b == "N" else (N, K), seed=seed + 1, complex_=True)
    c = generate_input("normal01", (M, N), seed=seed + 2, complex_=True)
    return a, b, c


def _cpu():
    return ozt.create(device="cpu")


@pytest.mark.parametrize("ns", [3, 8, 9, 12, 18])
@pytest.mark.parametrize("op_a,op_b", [("N", "N"), ("T", "N"), ("C", "T"), ("C", "C")])
def test_zgemm_bits_match_reference(ns, op_a, op_b):
    a, b, c = _operands(op_a, op_b, seed=ns)
    kw = dict(mode=f"fp64_int8_{ns}", op_a=op_a, op_b=op_b, alpha=2 - 0.5j, beta=0.25 + 1j, c=c)
    got = ozt.gemm(a, b, handle=_cpu(), **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128 and got.shape == (M, N)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, **kw)))


@pytest.mark.parametrize("ns", [3, 9])
def test_wide_spread_differs_only_by_the_subnormal_flush(ns):
    """exp_rand-8 planes whose row scales lie far apart: at small ns the
    accumulation space sits low, and aligning the four passes' terms
    drives f32 tail components below 2^-126.  XLA:CPU flushes those to
    zero and torch keeps them (ROADMAP.md queue 3); with the CPU's
    flush-to-zero switched on, the port returns the JAX package's bits."""
    a, b, c = _operands(dist="exp_rand-8", seed=3)
    kw = dict(mode=f"fp64_int8_{ns}", alpha=2 - 0.5j, beta=0.25 + 1j, c=c)
    want = oz.gemm(a, b, **kw)
    try:
        torch.set_flush_denormal(True)
        got = ozt.gemm(a, b, handle=_cpu(), **kw)
    finally:
        torch.set_flush_denormal(False)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    r = error_metrics(ozt.gemm(a, b, handle=_cpu(), **kw), None, None, c_ref=want)
    assert r["relative_residual"] < 1e-12


@pytest.mark.parametrize("alpha", [1.0, 2 - 0.5j, 1j])
@pytest.mark.parametrize("beta", [0.0, 1.0, 0.25 + 1j])
def test_zgemm_epilogue_bits_match_reference(alpha, beta):
    a, b, c = _operands(seed=20)
    kw = dict(mode="fp64_int8_9", alpha=alpha, beta=beta, c=c)
    got = ozt.gemm(a, b, handle=_cpu(), **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, **kw)))


def test_op_c_with_zero_imaginary_parts():
    """op C flips the sign of an all-zero imaginary plane to -0.0, as
    np.conj does; real operands are promoted (+0.0 imaginary parts)."""
    a, b, c = _operands("C", "C", seed=30)
    a = a.real + 0j
    b.imag[:, ::2] = 0.0
    kw = dict(mode="fp64_int8_9", op_a="C", op_b="C", alpha=-1.5 + 0j, beta=1.0, c=c)
    np.testing.assert_array_equal(_u64(ozt.gemm(a, b, handle=_cpu(), **kw)), _u64(oz.gemm(a, b, **kw)))
    kw.update(op_b="T")
    got = ozt.gemm(a, b.real.copy(), handle=_cpu(), **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b.real + 0j, **kw)))


@pytest.mark.parametrize("n_chunks", [2, 3, 7])
def test_chunked_equals_unchunked(n_chunks):
    a, b, c = _operands(seed=40)
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in (a.real, a.imag, b.real, b.imag)]
    cp = [torch.from_numpy(np.ascontiguousarray(p)) for p in (c.real, c.imag)]
    kw = dict(alpha=0.5 + 2j, beta=-1 + 0.5j, c_re=cp[0], c_im=cp[1])
    one = ozt.zgemm_f64(*planes, 9, n_chunks=1, **kw)
    many = ozt.zgemm_f64(*planes, 9, n_chunks=n_chunks, **kw)
    for x, y in zip(one, many):
        np.testing.assert_array_equal(x.numpy().view(np.uint64), y.numpy().view(np.uint64))
    want = oz.gemm(a, b, mode="fp64_int8_9", alpha=0.5 + 2j, beta=-1 + 0.5j, c=c)
    np.testing.assert_array_equal(_u64(one[0].numpy() + 1j * one[1].numpy()), _u64(want))


def test_auto_chunking_under_a_small_budget(monkeypatch):
    a, b, _ = _operands(seed=41)
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in (a.real, a.imag, b.real, b.imag)]
    want = ozt.zgemm_f64(*planes, 9, n_chunks=1)
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "0")
    got = ozt.zgemm_f64(*planes, 9)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(x.numpy().view(np.uint64), y.numpy().view(np.uint64))


def test_staged_profiled_path_is_bitwise():
    a, b, c = _operands(seed=50)
    h = _cpu()
    kw = dict(mode="fp64_int8_9", op_a="T", alpha=3 - 1j, beta=0.5j, c=c)
    a = a.T.copy()
    want = ozt.gemm(a, b, handle=h, **kw)
    ozt.enable_profiling(h)
    got = ozt.gemm(a, b, handle=h, **kw)
    ozt.disable_profiling(h)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, **kw)))
    phases = {row[0] for row in h.profiler.result_rows()}
    assert phases == {"split_A", "split_B", "int8tc+accumulate_in_f64", "copy_result"}
    ozt.clear_profiler_result(h)
    assert h.profiler.result_rows() == []


@pytest.mark.parametrize("dist,threshold", [("urand01", 0.0), ("normal01", 0.0), ("exp_rand-8", 40.0)])
def test_auto_on_complex_matches_reference(dist, threshold):
    """No mode: the shared four-plane counter picks the JAX package's int8
    mode, and the output bits are equal."""
    a, b, c = _operands(dist=dist, seed=60)
    planes = [np.ascontiguousarray(p) for p in (a.real, a.imag, b.real, b.imag)]
    mode = port_ml.auto_mode_select_complex(*(torch.from_numpy(p) for p in planes), K, threshold)
    want = ref_ml.auto_mode_select_complex(*(F64X.from_numpy(p) for p in planes), K, threshold)
    assert mode.value == want.value
    assert mode.is_int8
    h, hr = _cpu(), oz.create()
    h.avg_mantissa_loss_threshold = hr.avg_mantissa_loss_threshold = threshold
    got = ozt.gemm(a, b, alpha=1j, beta=2.0, c=c, handle=h)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, alpha=1j, beta=2.0, c=c, handle=hr)))
    np.testing.assert_array_equal(_u64(got), _u64(ozt.gemm(a, b, mode=mode, alpha=1j, beta=2.0, c=c,
                                                           handle=h)))


def test_tensor_complex_inputs_stay_tensors():
    a, b, c = _operands("N", "C", seed=70)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = ozt.gemm(ta, tb, mode="fp64_int8_9", op_b="C", alpha=2.0, beta=-1j, c=tc)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex128
    want = oz.gemm(a, b, mode="fp64_int8_9", op_b="C", alpha=2.0, beta=-1j, c=c)
    # a numpy result is built as re + 1j*im (numpy's signed zeros); the
    # tensor keeps the engine's exact planes
    re, im = got.real.numpy(), got.imag.numpy()
    np.testing.assert_array_equal(_u64(re + 1j * im), _u64(want))


def test_residual_gate_ns9():
    a = generate_input("urand01", (96, 160), seed=80, complex_=True)
    b = generate_input("urand01", (160, 80), seed=81, complex_=True)
    r = error_metrics(ozt.gemm(a, b, mode="fp64_int8_9", device="cpu"), a, b)
    assert r["relative_residual"] < 1e-15, r


def test_complex_dgemm_mode():
    """dgemm runs torch's complex128 matmul on the device, within
    2*k*2^-52*(|alpha|(|a|@|b|) + |beta||c|) of the JAX package's host
    numpy product (each side errs by at most half that)."""
    a, b, c = _operands(seed=90)
    kw = dict(mode="dgemm", alpha=1.5 - 1j, beta=0.5, c=c)
    got = ozt.gemm(a, b, handle=_cpu(), **kw)
    want = oz.gemm(a, b, **kw)
    bound = 2 * K * 2.0**-52 * (abs(1.5 - 1j) * (np.abs(a) @ np.abs(b)) + 0.5 * np.abs(c))
    assert (np.abs(got - want) <= bound).all()


def test_real_a_with_complex_b_is_promoted():
    """Complex if any operand is: a real ``a`` is promoted (+0.0
    imaginary parts), as the JAX package promotes a real ``b``."""
    a, b, c = _operands(seed=95)
    kw = dict(mode="fp64_int8_9", op_a="T", alpha=1j, beta=-2.0, c=c)
    ar = a.real.T.copy()
    got = ozt.gemm(ar, b, handle=_cpu(), **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(ar + 0j, b, **kw)))


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (2 - 0.5j, 1.0), (1j, 0.25 + 1j)])
def test_row_blocked_fold_is_bitwise(monkeypatch, rows, alpha, beta):
    """The complex fold over blocks of ``rows`` rows equals one block over
    the whole output, and the ZGEMM around it the JAX package's bits."""
    from ozimmu_tpu_torch.core import gemm as core

    a, b, c = _operands(seed=40)
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in (a.real, a.imag, b.real, b.imag)]
    cr, ci = (torch.from_numpy(np.ascontiguousarray(p)) for p in (c.real, c.imag))
    bb = ozt.bits_per_int8(K)
    a_planes = {0: core.split_f64(planes[0], 9, bb), 1: core.split_f64(planes[1], 9, bb)}
    b_planes = {0: core.split_f64_cols(planes[2], 9, bb), 1: core.split_f64_cols(planes[3], 9, bb)}
    SEs = core._zpasses(a_planes, b_planes, 9, bb, K)
    args = (SEs, M, N, complex(alpha), complex(beta), cr, ci, "cpu")
    whole = core._zfold_block(*args)
    block = rows * core._ZFOLD_TEMP_BYTES * N
    monkeypatch.setattr(core, "epilogue_block_bytes", lambda device: block)
    assert len(core._row_blocks(M, N, core._ZFOLD_TEMP_BYTES, "cpu")) == -(-M // rows)
    for got, want in zip(core._zfold_passes(*args), whole):
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want.numpy().view(np.uint64))
    kw = dict(mode="fp64_int8_9", alpha=alpha, beta=beta, c=c)
    np.testing.assert_array_equal(_u64(ozt.gemm(a, b, handle=_cpu(), **kw)),
                                  _u64(oz.gemm(a, b, **kw)))
