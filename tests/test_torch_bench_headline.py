"""The port's headline benchmark (``bench_torch.py``, the port of
``bench.py``) on the CPU: its record's contract (exactly bench.py's four
keys and wording, no committed TPU figures), its accuracy product against
the JAX package's engine bit for bit, the null baseline, the refusal to run
without a card, and that it and the two new tools import nothing of JAX.
Small shapes; the run at 16384^3 is on the card (``chip_smoke.py``)."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.core.gemm import _gemm_core  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _load(rel: str):
    path = os.path.join(REPO, rel)
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py")


def _main(**kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_torch.main(**kw)
    return rc, out.getvalue()


def test_run_gives_bench_pys_four_key_record():
    res = bench_torch.run(m=96, ns=9, iters=2, repeats=2, device="cpu", acc_size=64)
    rec = res["record"]
    assert set(rec) == KEYS
    assert not any(k.endswith("_committed") for k in rec)
    assert rec["metric"] == "fp64_int8_9 effective FP64 TFLOPS (m=n=k=96)"
    assert rec["unit"] == "TFLOPS"
    assert rec["value"] > 0 and np.isfinite(rec["value"])
    assert rec["vs_baseline"] > 0
    # value is 2 M^3 over the median of the repeats' ms per call
    assert rec["value"] == pytest.approx(2 * 96**3 / (np.median(res["engine_ms"]) / 1e3) / 1e12)
    assert len(res["engine_ms"]) == 2 and len(res["native_ms"]) == 2
    assert res["engine_calls"] == 3 + 2 * 2
    assert res["accuracy"]["relative_residual"] < 1e-15
    assert res["sampled"]["relative_residual"] < 1e-15


@pytest.mark.parametrize("ns", [9, 6])
def test_accuracy_product_equals_the_jax_engine(ns):
    """bench.py's accuracy check and the port's draw the same operands and
    compute the same bits."""
    c, err = bench_torch.accuracy_check(ns, 64, "cpu", np.random.default_rng(0))
    rng = np.random.default_rng(0)
    am = rng.uniform(size=(64, 64))
    bm = rng.uniform(size=(64, 64))
    want = _gemm_core(F64X.from_numpy(am), F64X.from_numpy(bm), ns, 1.0, 0.0).to_numpy()
    assert np.array_equal(c.view(np.uint64), want.reshape(64, 64).view(np.uint64))
    assert err["relative_residual"] < (1e-15 if ns == 9 else 1e-10)


def test_skip_native_gives_a_null_baseline(monkeypatch):
    monkeypatch.setenv("OZ_BENCH_M", "96")
    monkeypatch.setenv("OZ_BENCH_ITERS", "2")
    monkeypatch.setenv("OZ_BENCH_SKIP_NATIVE", "1")
    rc, out = _main(device="cpu", acc_size=64)
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS and rec["vs_baseline"] is None and rec["value"] > 0


def test_a_failed_baseline_gives_null_and_its_cause(monkeypatch, capsys):
    timed = bench_torch.timed_repeats

    def failing(what, *args):
        if what.startswith("torch.matmul"):
            raise RuntimeError("no baseline here")
        return timed(what, *args)

    monkeypatch.setattr(bench_torch, "timed_repeats", failing)
    res = bench_torch.run(m=64, ns=9, iters=1, repeats=1, device="cpu", acc_size=32)
    assert res["record"]["vs_baseline"] is None and res["record"]["value"] > 0
    assert "no baseline here" in res["native_error"]
    assert "vs_baseline null" in capsys.readouterr().err


def test_a_failed_engine_exits_1_with_nothing_on_stdout(monkeypatch):
    monkeypatch.setenv("OZ_BENCH_M", "64")

    def broken(*args, **kw):
        raise RuntimeError("engine down")

    monkeypatch.setattr(bench_torch, "gemm", broken)
    assert _main(device="cpu", acc_size=32) == (1, "")


def test_main_without_a_card_exits_1_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "CUDA GPU" in captured.err


def test_knobs_are_bench_pys():
    assert bench_torch.knobs({}) == {"m": 16384, "ns": 9, "iters": 4, "skip_native": False}
    assert bench_torch.knobs({"OZ_BENCH_M": "8192", "OZ_BENCH_NS": "8",
                              "OZ_BENCH_SKIP_NATIVE": "1"}) == {
        "m": 8192, "ns": 8, "iters": 6, "skip_native": True}
    assert bench_torch.knobs({"OZ_BENCH_ITERS": "2"})["iters"] == 2


def test_the_new_entry_points_never_import_jax():
    code = (
        "import importlib.util, sys\n"
        "for path in ('bench_torch.py', 'tools/torch_pareto_sweep.py',"
        " 'tools/torch_ci_digest.py'):\n"
        "    spec = importlib.util.spec_from_file_location(path.split('/')[-1][:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'ozimmu_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
