"""Fixtures of the harness's CPU tests: the harness on ``sys.path``, and a
copy of the benchmark cut to sizes that a CPU test can hold."""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: each cell's files at CPU sizes: the same drivers, references and limits
SMALL = {
    "traffic/dgemm-square-16384.json": {"m": 96, "n": 80, "k": 112, "soak_s": 0.05,
                                        "trace_lead_s": 0.05, "sample_entries": 256},
    "traffic/dgemm-batched-4x4096.json": {"m": 64, "n": 48, "k": 80, "soak_s": 0.05,
                                          "trace_units": 2, "trace_lead_s": 0.05,
                                          "sample_entries": 256},
    "traffic/intercept-1024-sync.json": {"m": 64, "n": 64, "k": 64, "soak_s": 0.05,
                                         "kept_from": 6, "kept_calls": 3, "trace_units": 4,
                                         "trace_lead_s": 0.05, "sample_entries": 256},
    "traffic/hpl-solves.json": {"soak_s": 0.05, "trace_lead_s": 0.05},
    "configs/hpl-n45056-nb1024.json": {"N": 160, "NB": 48},
}


def copy_benchmark(dest: str) -> str:
    """The benchmark's files (BENCHMARK.json and ozbench/) under ``dest``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH_DIR, os.path.join(dest, "ozbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def small(tmp_path, monkeypatch):
    """A copy of the benchmark at CPU sizes; the interceptor's thresholds
    lowered to those sizes for the test."""
    import ozimmu_tpu_torch as ozt

    root = copy_benchmark(str(tmp_path))
    for rel, changes in SMALL.items():
        path = os.path.join(root, "ozbench", rel)
        with open(path) as f:
            d = json.load(f)
        d.update(changes)
        with open(path, "w") as f:
            json.dump(d, f)
    lower_thresholds(monkeypatch.setattr)
    return root


def lower_thresholds(patch) -> None:
    """The interceptor's thresholds lowered to the CPU sizes of ``SMALL``;
    ``patch(obj, name, value)`` sets an attribute."""
    import ozimmu_tpu_torch as ozt

    h = ozt.default_handle()
    for axis in "mnk":
        patch(h, f"intercept_threshold_{axis}", 64)


def _native(a, b, **_):
    return a @ b


def _native_engine(a, b, num_split, alpha=1.0, beta=0.0, c=None):
    out = alpha * (a @ b)
    return out if c is None else out + beta * c


def fallback_program(cell: str, patch):
    """The program with its products done by float64 cuBLAS, not routed to
    the engine: as accurate, so only the traced run's look for the
    engine's kernels can catch it.  Returns the program to run, or None
    where ``patch`` planted the fault in the program itself."""
    import types

    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch.core import api

    if cell.startswith("hpl-"):
        patch(ozt.linalg, "_engine", _native_engine)
        return None
    if cell == "dgemm-1024-intercept":
        patch(api, "gemm", _native)
        return None
    return types.SimpleNamespace(gemm=_native, gemm_batched=_native)


_FRESH = """
import json, sys
sys.path.insert(0, sys.argv[1])
import conftest
root, cell, seed, fault = sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5]
conftest.lower_thresholds(setattr)
program = conftest.fallback_program(cell, setattr) if fault == "fallback" else None
r = conftest.run_small(root, cell, seed=seed, trace=True, program=program, device="cuda")
print(json.dumps(r))
"""


def traced_on_the_card(root: str, workload: str, seed: int, fault: str = "") -> dict:
    """A traced run of a cell of the copy at ``root`` on the card, in a
    process of its own as the benchmark's runs are: a process that has
    already run profiler sessions can lose a later trace's device
    records.  ``fault`` "fallback" plants :func:`fallback_program`."""
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "-c", _FRESH, here, root, workload, str(seed), fault],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def run_small(root: str, workload: str, seed: int = 2**31 + 7, trace: bool = False,
              program=None, device: str = "cpu") -> dict:
    """One run of a cell of the copy at ``root`` on ``device``, past the
    harness's look for a card."""
    import torch

    import run
    import ozimmu_tpu_torch as ozt

    return run.run_cell(workload, seed, 0.2, trace, root=root,
                        bench_dir=os.path.join(root, "ozbench"), device=torch.device(device),
                        program=program or ozt)


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
