"""The port's main path end to end on the CPU: ``ozimmu_tpu_torch.gemm``
returns the same f64 bits as ``ozimmu_tpu.gemm``, with a mode or with
none (AUTO); plus chunking, the residual gate, warm-up, the device trace,
the import boundary and the device rules of the wrappers."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch import testing  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda, split_cuda  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, K, N = 33, 47, 65


def _u64(x):
    return np.asarray(x, dtype=np.float64).view(np.uint64)


def _operands(dist="exp_rand-8", seed=0):
    a = testing.generate_input(dist, (M, K), seed=seed)
    b = testing.generate_input(dist, (K, N), seed=seed + 1)
    c = testing.generate_input("normal01", (M, N), seed=seed + 2)
    return a, b, c


@pytest.mark.parametrize("ns", [3, 8, 9, 12, 18])
def test_gemm_bits_match_reference(ns):
    a, b, _ = _operands(seed=ns)
    mode = f"fp64_int8_{ns}"
    got = ozt.gemm(a, b, mode=mode, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (M, N)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, mode=mode)))


@pytest.mark.parametrize("ns", [3, 8, 9, 12, 18])
def test_gemm_epilogue_bits_match_reference(ns):
    """op T / C with alpha, beta and c."""
    a, b, c = _operands(dist="normal01", seed=10 + ns)
    at, bt = a.T.copy(), b.T.copy()
    kw = dict(mode=f"fp64_int8_{ns}", op_a="T", op_b="C", alpha=-1.5, beta=0.25, c=c)
    got = ozt.gemm(at, bt, device="cpu", **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(at, bt, **kw)))
    # beta = 1 and alpha = 1 take the other epilogue branches
    kw.update(alpha=1.0, beta=1.0)
    got = ozt.gemm(at, bt, device="cpu", **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(at, bt, **kw)))


def test_tensor_inputs_stay_tensors():
    a, b, c = _operands(seed=4)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = ozt.gemm(ta, tb, mode="fp64_int8_9", alpha=2.0, beta=-1.0, c=tc)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64 and got.device.type == "cpu"
    want = oz.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=-1.0, c=c)
    np.testing.assert_array_equal(_u64(got.numpy()), _u64(want))


@pytest.mark.parametrize("n_chunks", [2, 3, 7])
def test_chunked_equals_unchunked(n_chunks):
    a, b, c = _operands(seed=20)
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    one = ozt.gemm_f64(ta, tb, 9, alpha=0.75, beta=-2.0, c=tc, n_chunks=1)
    many = ozt.gemm_f64(ta, tb, 9, alpha=0.75, beta=-2.0, c=tc, n_chunks=n_chunks)
    np.testing.assert_array_equal(_u64(many.numpy()), _u64(one.numpy()))
    want = oz.gemm(a, b, mode="fp64_int8_9", alpha=0.75, beta=-2.0, c=c)
    np.testing.assert_array_equal(_u64(one.numpy()), _u64(want))


def test_auto_chunking_under_a_small_budget(monkeypatch):
    a, b, _ = _operands(seed=21)
    want = ozt.gemm_f64(torch.from_numpy(a), torch.from_numpy(b), 9, n_chunks=1)
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", "0")  # forces the largest panel count
    got = ozt.gemm_f64(torch.from_numpy(a), torch.from_numpy(b), 9)
    np.testing.assert_array_equal(_u64(got.numpy()), _u64(want.numpy()))


def test_residual_gate_ns9():
    a = testing.generate_input("urand01", (96, 160), seed=30)
    b = testing.generate_input("urand01", (160, 80), seed=31)
    c = ozt.gemm(a, b, mode="fp64_int8_9", device="cpu")
    r = testing.error_metrics(c, a, b)
    assert r["relative_residual"] < 1e-15, r


def test_staged_profiled_path_is_bitwise():
    a, b, c = _operands(seed=40)
    h = ozt.create(device="cpu")
    want = ozt.gemm(a, b, mode="fp64_int8_9", alpha=3.0, beta=0.5, c=c, handle=h)
    h.profiler.enable()
    got = ozt.gemm(a, b, mode="fp64_int8_9", alpha=3.0, beta=0.5, c=c, handle=h)
    np.testing.assert_array_equal(_u64(got), _u64(want))
    phases = {row[0] for row in h.profiler.result_rows()}
    assert phases == {"split_A", "split_B", "int8tc+accumulate_in_f64", "copy_result"}
    assert ozt.destroy(h) == 0 and h.profiler.result_rows() == []


def test_dgemm_mode_is_float64_matmul():
    a, b, c = _operands(dist="normal01", seed=50)
    got = ozt.gemm(a, b, mode="dgemm", alpha=2.0, beta=-1.0, c=c, device="cpu")
    np.testing.assert_allclose(got, 2.0 * (a @ b) - c, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("p", [180, 190, 200])
def test_epilogue_keeps_a_subnormal_sticky_bit_at_a_tie(p):
    """beta * c alone is an exact half-ulp tie; alpha * a @ b, 180-200
    binades below it, must break the tie downward.  The port keeps the
    f32-subnormal tail that decides it and returns the correctly rounded
    f64.  (ozimmu_tpu on XLA:CPU flushes that tail to zero and rounds the
    tie to even, one ulp up: ROADMAP.md queue 3.)"""
    from fractions import Fraction

    a = np.array([[-(2.0 ** -(p // 2))]])
    b = np.array([[2.0 ** -(p - p // 2)]])
    c = np.array([[1.0 + 2.0**-52]])
    got = ozt.gemm(a, b, mode="fp64_int8_9", beta=1.5, c=c, device="cpu")
    exact = float(Fraction(1.5) * Fraction(c[0, 0]) + Fraction(a[0, 0]) * Fraction(b[0, 0]))
    assert got[0, 0] == exact == 1.5 + 2.0**-52


@pytest.mark.parametrize("dist", ["urand01", "normal01"])
@pytest.mark.parametrize("op_a,op_b", [("N", "N"), ("T", "C")])
def test_no_mode_is_auto_and_matches_reference(dist, op_a, op_b):
    """An unset mode resolves to fp64_int8_auto; on these operands AUTO
    picks an int8 mode (the same as the JAX package's), so the bits are
    equal."""
    a, b, c = _operands(dist=dist, seed=63)
    a = a if op_a == "N" else a.T.copy()
    b = b if op_b == "N" else b.T.copy()
    h = ozt.create(device="cpu")
    mode = ozt.auto_mode_select(a, b, op_a=op_a, op_b=op_b, handle=h)
    assert mode.is_int8
    kw = dict(op_a=op_a, op_b=op_b, alpha=-0.5, beta=2.0, c=c)
    got = ozt.gemm(a, b, handle=h, **kw)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, handle=oz.create(), **kw)))
    np.testing.assert_array_equal(_u64(got), _u64(ozt.gemm(a, b, mode=mode, handle=h, **kw)))
    if op_a == op_b == "N":
        got = ozt.matmul(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_array_equal(_u64(got.numpy()), _u64(oz.matmul(a, b)))


def test_warmup_and_reallocate_working_memory():
    from ozimmu_tpu_torch.schedule import working_set_bytes

    h = ozt.create(device="cpu")
    assert h.working_memory_bytes == 0
    ozt.warmup(8, 9, 10, "fp64_int8_9", handle=h)
    ozt.warmup(8, 9, 10, "fp64_int8_auto", ozt.ElementKind.COMPLEX, handle=h)
    ozt.warmup(8, 9, 10, "sgemm", "complex", handle=h)
    # the bytes form is a grow-only advisory
    assert ozt.reallocate_working_memory(h, 1000) == 1000
    assert ozt.reallocate_working_memory(h, 10) == 1000
    assert ozt.reallocate_working_memory(h, 5000) == 5000 == h.working_memory_bytes
    # the list form warms each entry up and returns the largest working set
    gemms = [
        (ozt.Operation.N, ozt.Operation.N, 16, 8, 24, ozt.ElementKind.REAL, "fp64_int8_9"),
        ("N", "T", 8, 8, 32, "complex", ozt.ComputeMode.FP64_INT8_12),
        ("N", "N", 64, 64, 64, "real", "dgemm"),
    ]
    want = max(working_set_bytes(16, 8, 24, 9), working_set_bytes(8, 8, 32, 12, complex_=True))
    assert ozt.reallocate_working_memory(h, gemms) == want
    assert h.working_memory_bytes == 5000


def test_device_trace_writes_a_trace_file(tmp_path):
    import json

    a, b, _ = _operands(seed=64)
    with ozt.device_trace(str(tmp_path / "trace")):
        got = ozt.gemm(a, b, mode="fp64_int8_9", device="cpu")
    (path,) = (tmp_path / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    np.testing.assert_array_equal(_u64(got), _u64(oz.gemm(a, b, mode="fp64_int8_9")))


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "args": {"correlation": corr}}


def _kernel(ts, corr):
    return {"cat": "kernel", "name": "k", "ts": ts, "args": {"correlation": corr}}


def test_trace_check_leaves_out_the_opening_launches():
    from ozimmu_tpu_torch.utils.profiling import launches_and_kernels

    # three opening launches (their kernels kept), then a block of two
    # launches whose kernels the trace dropped: the block has none
    events = [_launch(3.0, 3), _launch(1.0, 1), _launch(2.0, 2), _kernel(5.0, 1),
              _kernel(6.0, 2), _kernel(7.0, 3), _launch(10.0, 4),
              {"cat": "cuda_runtime", "name": "cuLaunchKernelEx", "ts": 11.0,
               "args": {"correlation": 5}},
              {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 12.0,
               "args": {"correlation": 6}},
              {"cat": "cpu_op", "name": "aten::add_", "ts": 0.5, "args": {}}]
    assert launches_and_kernels(events, skip=3) == (2, 0)
    assert launches_and_kernels(events + [_kernel(12.0, 5)], skip=3) == (2, 1)
    assert launches_and_kernels(events) == (5, 3)
    assert launches_and_kernels([]) == (0, 0)


def test_trace_check_counts_a_graph_launch_by_its_kernels():
    """A replayed chain's kernels all carry its ``cudaGraphLaunch``'s
    correlation id: the launch counts once, kept while any of its kernels
    is in the trace."""
    from ozimmu_tpu_torch.utils.profiling import launches_and_kernels

    graph = {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 20.0,
             "args": {"correlation": 7}}
    events = [_launch(1.0, 1), _kernel(2.0, 1), graph]
    assert launches_and_kernels(events, skip=1) == (1, 0)
    assert launches_and_kernels(events + [_kernel(21.0 + i, 7) for i in range(6)],
                                skip=1) == (1, 1)
    assert launches_and_kernels(events + [_kernel(21.0, 7)]) == (2, 2)
    assert launches_and_kernels([{**graph, "name": "cudaGraphLaunch_v10000"}]) == (1, 0)


def test_device_trace_raises_when_the_block_lost_every_kernel(tmp_path, monkeypatch):
    from ozimmu_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "launches_and_kernels", lambda events, skip=0: (14, 0))
    with pytest.raises(RuntimeError, match="14 kernel launches in the block but no device"):
        with ozt.device_trace(str(tmp_path / "trace")):
            torch.ones(4).add_(1)
    monkeypatch.setattr(profiling, "launches_and_kernels", lambda events, skip=0: (14, 1))
    with ozt.device_trace(str(tmp_path / "trace2")):
        torch.ones(4).add_(1)
    assert len(list((tmp_path / "trace2").iterdir())) == 1


def test_device_trace_opens_no_window_without_a_gpu(tmp_path, monkeypatch):
    from ozimmu_tpu_torch.utils import profiling

    def fail():
        raise AssertionError("open_trace_window called without a GPU")

    monkeypatch.setattr(profiling, "open_trace_window", fail)
    with ozt.device_trace(str(tmp_path / "trace")):
        torch.ones(4).add_(1)
    assert len(list((tmp_path / "trace").iterdir())) == 1


def test_bad_operands_raise(monkeypatch):
    a, b, c = _operands(seed=61)
    with pytest.raises(ValueError, match="shape mismatch"):
        ozt.gemm(a, a, mode="fp64_int8_9", device="cpu")
    with pytest.raises(ValueError, match="c has shape"):
        ozt.gemm(a, b, mode="fp64_int8_9", beta=1.0, c=c.T.copy(), device="cpu")
    with pytest.raises(ValueError, match="requires c"):
        ozt.gemm(a, b, mode="fp64_int8_9", beta=1.0, device="cpu")
    with pytest.raises(TypeError):
        ozt.gemm(torch.from_numpy(a).float(), torch.from_numpy(b).float(), mode="fp64_int8_9")
    bad = a.copy()
    bad[0, 0] = np.nan
    monkeypatch.setenv("OZIMMU_CHECK_FINITE", "1")
    with pytest.raises(ValueError, match="non-finite"):
        ozt.gemm(bad, b, mode="fp64_int8_9", device="cpu")


def test_numpy_inputs_default_to_cuda():
    """The handle's default device is "cuda": without a GPU torch raises,
    and nothing moves to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the CPU-only behaviour")
    a, b, _ = _operands(seed=62)
    assert ozt.create().device == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        ozt.gemm(a, b, mode="fp64_int8_9")


def test_cuda_wrappers_raise_on_cpu_tensors():
    before = (split_cuda.LAUNCHES, recombine_cuda.LAUNCHES)
    x = torch.ones((4, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        split_cuda.split_digits(x, torch.zeros(4, dtype=torch.int32), 9, 7, 1)
    d = torch.zeros((9, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        recombine_cuda.recombine(d, d.transpose(1, 2).contiguous(), 9, 7, 8)
    assert (split_cuda.LAUNCHES, recombine_cuda.LAUNCHES) == before


def test_port_never_imports_jax():
    code = (
        "import ozimmu_tpu_torch.intercept, ozimmu_tpu_torch.traced, ozimmu_tpu_torch.bench_cli\n"
        "import ozimmu_tpu_torch.parallel, ozimmu_tpu_torch.parallel.local\n"
        "import glob, importlib, importlib.util, pkgutil, sys, ozimmu_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ozimmu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "examples = sorted(glob.glob('examples/torch_*.py'))\n"
        "assert len(examples) == 9, examples\n"
        "for path in examples:  # each runs only under __main__\n"
        "    spec = importlib.util.spec_from_file_location(path[:-3].replace('/', '_'), path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'ozimmu_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_package_exports_its_modules():
    """``hostref``, ``schedule``, ``testing``, ``types`` and ``parallel``
    resolve right after ``import ozimmu_tpu_torch`` (a fresh process) and
    are listed."""
    code = (
        "import types, ozimmu_tpu_torch as ozt\n"
        "for name in ('hostref', 'parallel', 'schedule', 'testing', 'types'):\n"
        "    assert name in ozt.__all__, name\n"
        "    assert isinstance(getattr(ozt, name), types.ModuleType), name\n"
        "assert callable(ozt.testing.generate_input) and callable(ozt.parallel.sharded_gemm)\n"
        "assert callable(ozt.hostref.gemm_fp64)\n"
        "print('exported')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "exported" in out.stdout, out.stderr


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.5, 0.0), (1.0, 1.0), (-1.5, 0.25),
                                        (2.0, 1.0)])
def test_row_blocked_epilogue_is_bitwise(monkeypatch, rows, alpha, beta):
    """The epilogue over blocks of ``rows`` rows (a strided c included)
    equals one block over the whole output, and the GEMM around it the
    JAX package's bits."""
    from ozimmu_tpu_torch.core import gemm as core

    a, b, c = _operands(dist="normal01", seed=30)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cw = torch.from_numpy(np.ascontiguousarray(np.hstack([c, c])))[:, ::2]  # a strided window
    bb = ozt.bits_per_int8(K)
    da, pa = core.split_f64(ta, 9, bb)
    db, pb = core.split_f64_cols(tb, 9, bb)
    S = core.recombine(da, db, 9, bb, K)
    E = core._exponent_plane(pa, pb, core.acc_shift(9, bb))
    cc = cw if beta != 0.0 else None
    whole = core._epilogue_block(S, E, alpha, beta, cc)
    block = rows * core._EPILOGUE_TEMP_BYTES * N
    monkeypatch.setattr(core, "epilogue_block_bytes", lambda device: block)
    assert len(core._row_blocks(M, N, core._EPILOGUE_TEMP_BYTES, "cpu")) == -(-M // rows)
    np.testing.assert_array_equal(_u64(core._epilogue_SE(S, E, alpha, beta, cc).numpy()),
                                  _u64(whole.numpy()))
    kw = dict(mode="fp64_int8_9", alpha=alpha, beta=beta, c=c if beta != 0.0 else None)
    np.testing.assert_array_equal(_u64(ozt.gemm(a, b, device="cpu", **kw)),
                                  _u64(oz.gemm(a, b, **kw)))
