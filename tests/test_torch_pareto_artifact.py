"""The port's accuracy-vs-throughput sweep (``tools/torch_pareto_sweep.py``,
the port of ``tools/pareto_sweep.py``) and its committed H100 evidence.

On the CPU at size 64 every int8 row equals the JAX package's ``gemm`` bit
for bit and every residual comes from one shared oracle product.  The
committed CSVs, ``tests/artifacts/torch_pareto_{real,complex}_4096.csv``,
are the verbatim output of ``python tools/torch_pareto_sweep.py 4096
[--complex]`` on an NVIDIA H100: the audits below hold their claims (the
accuracy staircase, the f64 floor from ns = 8, throughput falling with the
pair count) and hold each int8 residual against the TPU's own sweep
(``tests/artifacts/pareto_{real,complex}_4096.csv``): the same operands, the
same engine bits, the same scoring (the JAX tool's real rows against the
long-double product rounded to f64, which the sweep's ``--rounded-ref``
file reproduces: see ``test_committed_sweep_residuals_match_the_tpus``).
"""

import csv
import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
from ozimmu_tpu_torch import oracle  # noqa: E402
from ozimmu_tpu_torch.bench_cli import CSV_HEADER  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "tests", "artifacts")
MODES = [f"fp64_int8_{ns}" for ns in range(3, 19)]
KINDS = [("real", "D", False), ("complex", "Z", True)]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3],
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep_tool = _load("tools/torch_pareto_sweep.py")


def _rows(name):
    with open(os.path.join(ART, name)) as f:
        header = f.readline().strip()
        f.seek(0)
        return header, {r["mode"]: r for r in csv.DictReader(f)}


def test_mode_lists_are_the_jax_tools():
    assert sweep_tool.modes_of() == MODES + ["dgemm", "sgemm"]
    assert sweep_tool.modes_of("8, 9,dgemm,fp64_int8_7") == [
        "fp64_int8_8", "fp64_int8_9", "dgemm", "fp64_int8_7"]


@pytest.mark.parametrize("kind,letter,complex_", KINDS)
def test_sweep_rows_equal_the_jax_engine(monkeypatch, kind, letter, complex_):
    """Size 64 on the CPU: each int8 row's product == ``ozimmu_tpu.gemm``
    bit for bit; one oracle call scores every row."""
    calls = []
    multi = oracle.error_metrics_multi

    def counted(cs, a, b, threads=1, ref64=None):
        calls.append(len(cs))
        return multi(cs, a, b, threads=threads, ref64=ref64)

    monkeypatch.setattr(oracle, "error_metrics_multi", counted)
    modes = sweep_tool.modes_of()
    rows, results, rounded = sweep_tool.sweep(64, modes, complex_=complex_, test_count=1,
                                              device="cpu")
    assert calls == [len(modes)]
    assert len(rounded) == (0 if complex_ else len(modes))
    a = generate_input("urand01", (64, 64), seed=0, complex_=complex_)
    b = generate_input("urand01", (64, 64), seed=1, complex_=complex_)
    view = np.uint64
    for mode in MODES:
        want = np.asarray(oz.gemm(a, b, mode=mode))
        assert results[mode].dtype == want.dtype
        assert np.array_equal(results[mode].view(view), want.view(view)), mode
    errs = multi([results[m] for m in modes], a, b)
    assert len(rows) == len(modes)
    for row, mode, err in zip(rows, modes, errs):
        f = row.split(",")
        assert len(f) == len(CSV_HEADER.split(","))
        assert f[:9] == ["cpu", letter, "urand01", mode, "N", "N", "64", "64", "64"]
        assert f[9] == f"{err['relative_residual']:e}" and f[10] == f"{err['max_relative_error']:e}"
        assert float(f[11]) > 0


def test_no_oracle_leaves_the_residuals_nan():
    rows, results, rounded = sweep_tool.sweep(32, ["fp64_int8_9", "sgemm"], with_oracle=False,
                                              test_count=1, device="cpu")
    assert results == {} and rounded == []
    for row in rows:
        f = row.split(",")
        assert math.isnan(float(f[9])) and math.isnan(float(f[10])) and float(f[11]) > 0


@pytest.mark.parametrize("kind,letter,complex_", KINDS)
def test_committed_sweep_rows(kind, letter, complex_):
    header, rows = _rows(f"torch_pareto_{kind}_4096.csv")
    assert header == CSV_HEADER
    assert list(rows) == MODES + ["dgemm", "sgemm"]
    for mode, r in rows.items():
        assert r["gemm"] == letter and r["m"] == r["n"] == r["k"] == "4096"
        assert r["input"] == "urand01" and r["opA"] == r["opB"] == "N"
        assert r["device"].startswith("NVIDIA H100"), r["device"]
        tf = float(r["tflops"])
        assert math.isfinite(tf) and tf > 0, f"{kind}: {mode} not timed"
        assert math.isfinite(float(r["residual"])) and math.isfinite(float(r["max_relative"]))


@pytest.mark.parametrize("kind,letter,complex_", KINDS)
def test_committed_sweep_accuracy_staircase(kind, letter, complex_):
    _, rows = _rows(f"torch_pareto_{kind}_4096.csv")
    res = [float(rows[m]["residual"]) for m in MODES]
    for i in range(5):  # ns = 3..8 lie clearly above the f64 floor
        assert res[i + 1] < res[i] * 0.1, f"{kind}: not decaying at ns={i + 3}->{i + 4}"
    for ns in range(8, 19):  # from ns = 8 on, inside the reference's CI gate
        assert res[ns - 3] < 1e-15, f"{kind}: fp64_int8_{ns} residual {res[ns - 3]}"


@pytest.mark.parametrize("kind,letter,complex_", KINDS)
def test_committed_sweep_throughput_falls_with_the_pairs(kind, letter, complex_):
    _, rows = _rows(f"torch_pareto_{kind}_4096.csv")
    tf = {m: float(rows[m]["tflops"]) for m in MODES}
    for ns in range(8, 18):
        assert tf[f"fp64_int8_{ns + 1}"] < tf[f"fp64_int8_{ns}"] * 1.05, (kind, ns)


#: real modes whose residual lies far enough above f64's own rounding
#: (about 5e-17 of these products) that rounding the reference to f64 does
#: not show at 1 % (below)
REAL_ABOVE_ROUNDING = [f"fp64_int8_{ns}" for ns in range(3, 8)]
ROUNDED_REF = "torch_pareto_real_4096_rounded_ref.csv"


def _rounded_rows():
    with open(os.path.join(ART, ROUNDED_REF)) as f:
        header = f.readline().strip()
        f.seek(0)
        return header, {r["mode"]: r for r in csv.DictReader(f)}


def test_committed_rounded_ref_rows():
    """The real sweep's ``--rounded-ref`` file, written in the same oracle
    pass as ``torch_pareto_real_4096.csv``: one row per mode, finite."""
    header, rows = _rounded_rows()
    assert header == sweep_tool.ROUNDED_REF_HEADER
    assert list(rows) == MODES + ["dgemm", "sgemm"]
    for mode, r in rows.items():
        assert math.isfinite(float(r["residual"])) and math.isfinite(float(r["max_relative"]))
    _, card = _rows("torch_pareto_real_4096.csv")
    for mode in REAL_ABOVE_ROUNDING:  # far above f64's rounding both scorings agree
        assert float(rows[mode]["residual"]) == pytest.approx(
            float(card[mode]["residual"]), rel=1e-3, abs=0.0)


@pytest.mark.parametrize("kind,letter,complex_", KINDS)
def test_committed_sweep_residuals_match_the_tpus(kind, letter, complex_):
    """Same operands, same engine bits, the same scoring: each int8
    residual within 1 % of the TPU's sweep.

    The JAX tool scores its complex rows against the long-double product,
    as the port does, and its real rows against that product rounded to
    f64 (``native.ref_gemm_native``: ``oz_ref_gemm_d`` stores
    ``(double)acc``).  So the card's real rows are held here through the
    sweep's ``--rounded-ref`` file, which scores them the JAX tool's way
    (``test_rounded_ref_rows_are_the_jax_tools_scoring``); the card's own
    real residuals agree with the TPU's only where f64's rounding is
    negligible (ns = 3..7), and are held there too."""
    _, card = _rows(f"torch_pareto_{kind}_4096.csv")
    _, tpu = _rows(f"pareto_{kind}_4096.csv")
    held = [(m, card[m]["residual"]) for m in MODES] if complex_ else (
        [(m, r["residual"]) for m, r in _rounded_rows()[1].items() if m in MODES]
        + [(m, card[m]["residual"]) for m in REAL_ABOVE_ROUNDING])
    assert len(held) == (16 if complex_ else 21)
    off = {m: (got, tpu[m]["residual"]) for m, got in held
           if float(got) != pytest.approx(float(tpu[m]["residual"]), rel=0.01, abs=0.0)}
    assert not off, off


def test_the_jax_tools_real_reference_is_rounded():
    """On the same bits (size 128 on the CPU), the JAX tool's real scoring
    (``error_metrics`` against ``ref_gemm_native``, the f64-rounded
    long-double product) and the port's oracle agree where the residual
    is far above f64's rounding and part at the floor, where the rounded
    reference hides most of the result's own rounding."""
    from ozimmu_tpu import native
    from ozimmu_tpu.testing import error_metrics

    a = generate_input("urand01", (128, 128), seed=0)
    b = generate_input("urand01", (128, 128), seed=1)
    modes = ["fp64_int8_5", "fp64_int8_12"]
    _, results, _ = sweep_tool.sweep(128, modes, test_count=1, device="cpu")
    ref64 = native.ref_gemm_native(a, b)
    jax_tool = [error_metrics(results[m], a, b, c_ref=ref64)["relative_residual"] for m in modes]
    port = [e["relative_residual"] for e in oracle.error_metrics_multi(
        [results[m] for m in modes], a, b)]
    assert jax_tool[0] == pytest.approx(port[0], rel=1e-3, abs=0.0)
    assert jax_tool[1] < 0.5 * port[1] and port[1] < 1e-16


@pytest.mark.parametrize("size", [64, 130])
def test_rounded_ref_rows_are_the_jax_tools_scoring(size):
    """The sweep's rounded-reference rows (CPU, real) equal the JAX tool's
    own scoring of the same bits: ``error_metrics`` against
    ``native.ref_gemm_native``, field by field as printed."""
    from ozimmu_tpu import native
    from ozimmu_tpu.testing import error_metrics

    a = generate_input("urand01", (size, size), seed=0)
    b = generate_input("urand01", (size, size), seed=1)
    modes = ["fp64_int8_4", "fp64_int8_8", "fp64_int8_12", "dgemm"]
    _, results, rounded = sweep_tool.sweep(size, modes, test_count=1, device="cpu")
    ref64 = native.ref_gemm_native(a, b)
    for mode, line in zip(modes, rounded):
        e = error_metrics(results[mode], a, b, c_ref=ref64)
        assert line == f"{mode},{e['relative_residual']:e},{e['max_relative_error']:e}"


def test_main_exits_1_when_a_row_was_not_timed(monkeypatch, capsys):
    """A timing failure reads nan in the CSV, as in the JAX tool, and the
    run's exit code is 1."""
    row = "NVIDIA H100 80GB HBM3,D,urand01,{},N,N,64,64,64,1e-16,1e-16,{}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(sweep_tool, "sweep", lambda *a, **k: (
        [row.format("fp64_int8_9", "2.0e+01"), row.format("sgemm", "nan")], {}, []))
    assert sweep_tool.main(["64", "9,sgemm", "--no-oracle"]) == 1
    out, err = capsys.readouterr()
    assert out.splitlines()[0] == CSV_HEADER and len(out.splitlines()) == 3
    assert "timing failed for sgemm" in err
    monkeypatch.setattr(sweep_tool, "sweep", lambda *a, **k: (
        [row.format("fp64_int8_9", "2.0e+01")], {}, []))
    assert sweep_tool.main(["64", "9", "--no-oracle"]) == 0
