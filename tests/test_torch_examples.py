"""The port's single-process examples (``examples/torch_0{1,2,4,5,6,8}_*.py``)
on the CPU at small sizes: what each ``main(device="cpu")`` returns is
held against the JAX package's own functions on the same numpy inputs —
bitwise for the GEMMs, AUTO's choice and the host-panel LU, under the
example's residual gate elsewhere; each script runs with ``--device cpu``
and exits 0, and without ``--device`` on a machine with no GPU it stops
at once with a reason."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
from ozimmu_tpu import linalg as oz_linalg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
#: example -> its small n for the CPU
SMALL = {
    "torch_01_basic_gemm": 128,
    "torch_02_interception": 256,
    "torch_04_profiling": 128,
    "torch_05_iterative_refinement": 128,
    "torch_06_compiled": 64,
    "torch_08_hpl_lu": 128,
}
#: examples whose ``torch.compile`` the tests run with the ``aot_eager``
#: backend (Inductor's C++ build takes tens of seconds on the CPU), in
#: process through :func:`aot_eager` and as a script through this prelude
AOT_EAGER = {"torch_06_compiled"}
AOT_EAGER_PRELUDE = ("import functools, runpy, sys, torch; "
                     "torch.compile = functools.partial(torch.compile, backend='aot_eager'); "
                     "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")


@pytest.fixture
def aot_eager(monkeypatch):
    import functools

    monkeypatch.setattr(torch, "compile", functools.partial(torch.compile, backend="aot_eager"))


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _u64(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.float64).view(np.uint64) if np.iscomplexobj(x) else x.view(np.uint64)


def _same_bits(got, want):
    np.testing.assert_array_equal(_u64(got), _u64(want))


def test_basic_gemm_equals_the_jax_package():
    r = load("torch_01_basic_gemm").main(device="cpu", n=128)
    a, b = r["a"], r["b"]
    _same_bits(r["c"], oz.matmul(a, b, mode="fp64_int8_9"))
    _same_bits(r["c2"], oz.gemm(a, b, mode="fp64_int8_9", op_a="T", alpha=2.0, beta=1.0,
                                c=r["c"]))
    h = r["wide"].shape[0]
    assert r["auto_exact"].value == oz.auto_mode_select(r["wide"], b[:h, :h]).value
    assert r["auto_budget"].value == oz.auto_mode_select(r["wide"], b[:h, :h],
                                                         threshold=2.0).value
    _same_bits(r["z"], oz.gemm(r["za"], r["zb"], mode="fp64_int8_9"))
    assert r["residual"] < 1e-15 and r["epilogue_ok"]


def test_interception_routes_what_the_jax_package_routes():
    env_before = os.environ.get("OZIMMU_COMPUTE_MODE")
    r = load("torch_02_interception").main(device="cpu", n=256)
    assert os.environ.get("OZIMMU_COMPUTE_MODE") == env_before  # restored
    a, b = r["a"].numpy(), r["b"].numpy()
    want = oz.matmul(a, b, mode="fp64_int8_9")
    for key in ("c1", "c2", "c3"):  # the dispatch mode, F.linear, OZIMMU_COMPUTE_MODE
        _same_bits(r[key], want)
    assert r["small_native"]
    assert max(r["eager_residual"], r["linear_residual"], r["env_residual"]) < 1e-15


def test_profiling_writes_phases_and_a_trace(tmp_path):
    r = load("torch_04_profiling").main(device="cpu", n=128, trace_dir=str(tmp_path))
    _same_bits(r["c"], oz.matmul(r["a"], r["b"], mode="fp64_int8_9"))
    assert r["phases"] and set(r["phases"].values()) == {2}
    assert {"split_A", "split_B"} <= set(r["phases"])
    assert r["trace_dir"] == str(tmp_path) and any(f.endswith(".json") for f in r["trace_files"])
    assert r["trace_attempts"] == 1


@pytest.mark.parametrize("lost", [1, 3])
def test_profiling_traces_again_when_the_trace_is_lost(tmp_path, monkeypatch, lost):
    import contextlib

    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch.utils.profiling import TraceLostError

    calls = []

    @contextlib.contextmanager
    def losing_trace(log_dir):  # the first ``lost`` traces keep no kernel
        calls.append(log_dir)
        yield
        if len(calls) <= lost:
            raise TraceLostError("device_trace: 14 kernel launches in the block but no device "
                                 "kernel in the trace")

    ex = load("torch_04_profiling")
    monkeypatch.setattr(ozt, "device_trace", losing_trace)
    if lost < ex.TRACE_ATTEMPTS:
        r = ex.main(device="cpu", n=64, trace_dir=str(tmp_path))
        assert r["trace_attempts"] == lost + 1 == len(calls)
        _same_bits(r["c"], oz.matmul(r["a"], r["b"], mode="fp64_int8_9"))
    else:
        with pytest.raises(TraceLostError):
            ex.main(device="cpu", n=64, trace_dir=str(tmp_path))
        assert len(calls) == ex.TRACE_ATTEMPTS


def test_iterative_refinement_follows_the_jax_package():
    r = load("torch_05_iterative_refinement").main(device="cpu", n=128)
    A, b, x_true = r["A"], r["b"], r["x_true"]
    A32 = A.astype(np.float32)
    x = np.linalg.solve(A32, b.astype(np.float32)).astype(np.float64)
    for _ in range(len(r["errors"]) - 1):
        x = x + np.linalg.solve(
            A32, (b - oz.matmul(A, x, mode="fp64_int8_9")).astype(np.float32)).astype(np.float64)
    _same_bits(r["x"], x)
    assert r["converged"] and r["errors"][-1] < 1e-14
    assert r["errors"][-1] == np.linalg.norm(x - x_true) / np.linalg.norm(x_true)


def test_compiled_equals_the_jax_package(aot_eager):
    r = load("torch_06_compiled").main(device="cpu", n=64)
    a, b, c = (r[k].numpy() for k in ("a", "b", "c"))
    g = oz.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=1.0, c=c)
    _same_bits(r["host"], g)
    _same_bits(r["compiled"], g)
    _same_bits(r["g2"], oz.matmul(g, b, mode="fp64_int8_9"))
    _same_bits(r["batched"], oz.gemm_batched(np.stack([a, 2 * a]), np.stack([b, b]),
                                             mode="fp64_int8_9"))
    assert r["bitwise"] and r["trace_ok"] and r["residual"] < 1e-15


def test_hpl_lu_equals_the_jax_package_on_host_panels():
    n, block = 128, 32
    r = load("torch_08_hpl_lu").main(device="cpu", n=n, block=block)
    A, b, B = r["A"], r["b"], r["B"]
    _same_bits(r["x9"], oz_linalg.solve(A, b, mode="fp64_int8_9", block=block))
    fac5 = oz_linalg.lu_factor(A, mode="fp64_int8_5", block=block)
    _same_bits(r["fac5"][0], fac5[0])
    np.testing.assert_array_equal(r["fac5"][1], fac5[1])
    for k, x in r["refined"].items():
        _same_bits(x, oz_linalg.solve(A, b, factor=fac5, refine=k))
    fac = oz_linalg.lu_factor(A, mode="fp64_int8_9", block=block)
    _same_bits(r["fac"][0], fac[0])
    _same_bits(r["X"], oz_linalg.lu_solve(fac, B))
    # the gate of the solves; the unrefined ns = 5 solve is the cheap
    # factor's own (refinement is there to fix it)
    assert max(r["residual_9"], r["residual_refined"][3], r["multi_rhs_scaled_residual"]) < 1e-14
    assert r["residual_refined"][3] < r["residual_5"]


#: scripts run at once by :func:`script_runs` (the suite's other workers
#: share the machine's cores)
AT_ONCE = 3


@pytest.fixture(scope="module")
def script_runs():
    """Every script twice: with no arguments (``cuda`` by default), and
    with ``--device cpu --n <small>``; ``AT_ONCE`` runs at a time.  Returns
    ``{(name, "default" | "cpu"): CompletedProcess}``."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    runs = [((name, kind), [] if kind == "default" else ["--device", "cpu", "--n", str(n)])
            for kind in ("default", "cpu") for name, n in SMALL.items()]
    results = {}
    for i in range(0, len(runs), AT_ONCE):
        procs = {}
        try:
            for key, args in runs[i:i + AT_ONCE]:
                prelude = ["-c", AOT_EAGER_PRELUDE] if key[0] in AOT_EAGER else []
                procs[key] = subprocess.Popen(
                    [sys.executable, *prelude, os.path.join(EXAMPLES, f"{key[0]}.py"), *args],
                    cwd=REPO,
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for key, p in procs.items():
                stdout, stderr = p.communicate(timeout=300)
                results[key] = subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


@pytest.mark.parametrize("name", sorted(SMALL))
def test_script_runs_on_the_cpu(script_runs, name):
    out = script_runs[name, "cpu"]
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip(), "the example printed nothing"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_script_without_a_gpu_stops_at_once(script_runs, name):
    """No ``--device``: the default is ``cuda``; with no GPU the example
    raises before any work, saying why (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = script_runs[name, "default"]
    assert out.returncode != 0
    assert "no CUDA GPU" in out.stderr and "--device cpu" in out.stderr
    assert not out.stdout.strip(), out.stdout
