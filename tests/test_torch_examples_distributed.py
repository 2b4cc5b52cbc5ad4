"""The port's distributed examples (``examples/torch_03_distributed.py``,
``torch_07_multiprocess.py``, ``torch_09_north_star_feeding.py``) on four
gloo ranks on the CPU at small sizes: rank 0's results equal the JAX
package's ``gemm`` (and AUTO's choice) on the same inputs, bit for bit.
Apart from ``test_torch_examples.py``: each launch of four rank processes
takes ~15 s, and ``--dist loadfile`` gives each file one worker."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
N = 64
DISTRIBUTED = ["torch_03_distributed", "torch_07_multiprocess", "torch_09_north_star_feeding"]


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _u64(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.float64).view(np.uint64) if np.iscomplexobj(x) else x.view(np.uint64)


def _same_bits(got, want):
    np.testing.assert_array_equal(_u64(got), _u64(want))


@pytest.fixture(scope="module")
def ex03():
    module = load("torch_03_distributed")
    return module, module.main(device="cpu", n=N)


#: case -> (result key, how the JAX package computes it from data(N))
CASES_03 = {
    "summa": ("c", lambda d: oz.gemm(d["a"], d["b"], mode="fp64_int8_9")),
    "epilogue": ("c_ep", lambda d: oz.gemm(d["a"], d["b"], mode="fp64_int8_9", alpha=2.0,
                                           beta=1.0, c=d["c0"])),
    "zgemm": ("z", lambda d: oz.gemm(d["za"], d["zb"], mode="fp64_int8_9")),
    "ring": ("c_ring", lambda d: oz.gemm(d["a"], d["b"], mode="fp64_int8_9")),
    "auto_gemm": ("c_auto", lambda d: oz.gemm(d["aw"], d["bw"], mode="fp64_int8_auto")),
    "tall_k": ("zk", lambda d: oz.gemm(d["zk_a"], d["zk_b"], mode="fp64_int8_10")),
}


@pytest.mark.parametrize("case", sorted(CASES_03))
def test_distributed_case_equals_the_jax_package(ex03, case):
    module, results = ex03
    key, jax_fn = CASES_03[case]
    res = results[case]
    assert res["bitwise"], f"{case}: rank 0 differs from the one-device gemm"
    _same_bits(res[key], jax_fn(module.data(N)))


def test_distributed_auto_picks_what_the_jax_package_picks(ex03):
    module, results = ex03
    d = module.data(N)
    res = results["auto_select"]
    assert res["same"] and res["mode"] == res["single_device_mode"]
    assert res["mode"] == oz.auto_mode_select(d["aw"], d["bw"]).value
    assert tuple(results["summa"]["mesh"]) == (2, 2) and results["summa"]["residual"] < 1e-15


@pytest.fixture(scope="module")
def ex07():
    module = load("torch_07_multiprocess")
    return module, module.main(device="cpu", n=N)


def test_multiprocess_workers_agree_bitwise(ex07):
    """Four ranks as 2 hosts x 2 on the hybrid mesh: a bitwise line from
    every one."""
    _, res = ex07
    assert len(res["lines"]) == 4 and all(r["bitwise"] for r in res["results"]), res["lines"]
    assert all(line.endswith("bitwise == single-device") for line in res["lines"]), res["lines"]
    assert all("mesh 2x2 over 2 hosts" in line for line in res["lines"]), res["lines"]


def test_multiprocess_case_table_equals_the_jax_package(ex07):
    """The ranks' body through the launcher's case table: rank 0's
    gathered result equals the JAX package's gemm."""
    module, res = ex07
    a, b = module.operands(2, 2, N)
    _same_bits(res["results"][0]["got"], oz.gemm(a, b, mode="fp64_int8_9"))


def test_multiprocess_parent_fails_when_a_worker_fails():
    """A rank that cannot start (no NCCL on the CPU) makes the example
    raise, with every rank gone."""
    with pytest.raises(RuntimeError, match="exited with"):
        load("torch_07_multiprocess").main(device="cpu", n=N, backend="nccl", timeout=120)


@pytest.mark.parametrize("name", DISTRIBUTED)
def test_more_nccl_ranks_than_gpus_stop_at_once(monkeypatch, name):
    """Four NCCL ranks on a machine with one GPU: the example raises
    before it starts a rank and names ``--backend gloo``."""
    module = load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--backend gloo"):
        module.main(device="cuda", n=N)


def test_north_star_feeding_equals_the_jax_package():
    module = load("torch_09_north_star_feeding")
    res = module.main(device="cpu", n=N)
    assert res["bitwise"] and res["residual"] < 1e-15
    assert tuple(res["mesh"]) == (2, 2)
    a = module.synth((N, N))((slice(0, N), slice(0, N)))
    _same_bits(res["c"], oz.gemm(a, a, mode="fp64_int8_9"))


@pytest.fixture(scope="module")
def no_gpu_runs():
    procs = {name: subprocess.Popen([sys.executable, os.path.join(EXAMPLES, f"{name}.py")],
                                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name in DISTRIBUTED}
    results = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            results[name] = subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


@pytest.mark.parametrize("name", DISTRIBUTED)
def test_script_without_a_gpu_stops_at_once(no_gpu_runs, name):
    """No ``--device``: the default is ``cuda``; with no GPU the script
    raises before it starts a rank, saying why."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = no_gpu_runs[name]
    assert out.returncode != 0
    assert "no CUDA GPU" in out.stderr and "--device cpu" in out.stderr
    assert not out.stdout.strip(), out.stdout
