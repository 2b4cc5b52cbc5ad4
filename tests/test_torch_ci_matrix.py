"""The port's whole accuracy gate and its committed H100 evidence
(``tools/torch_ci_digest.py``, the port of ``tools/ci_digest.py``).

The digest tool runs ``bench_cli ci_test --seeds crc32`` on the card (1944
cases: m, n, k in {1023, 1024, 1025}, op N/T on each side, fp64_int8_8..16,
real and complex; the operand seeds of the JAX package's
``tools/ci_full_runner.py``) and writes per-set logs and a digest into
``tests/artifacts/torch_ci_full_*``.  Here, on the CPU: the digest of a
synthetic ``ci_test`` output, the crc32 rows against the JAX package's
engine and oracle, and the audit of the committed H100 evidence, set by set
against the TPU's (``tests/artifacts/ci_full_digest.json``).
"""

import contextlib
import importlib.util
import io
import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
from ozimmu_tpu import native  # noqa: E402
from ozimmu_tpu.testing import generate_input  # noqa: E402
from ozimmu_tpu_torch import bench_cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "tests", "artifacts")
MODES = [f"fp64_int8_{ns}" for ns in range(8, 17)]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3],
                                                  os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


digest_tool = _load("tools/torch_ci_digest.py")


def _row(kind, mode, op_a, op_b, m, n, k, residual, max_rel=1e-16):
    return (f"NVIDIA H100 80GB HBM3,{kind},urand01,{mode},{op_a},{op_b},{m},{n},{k},"
            f"{residual:e},{max_rel:e},nan\n")


def test_digest_of_a_synthetic_gate():
    """Two shapes x two op pairs per kind, one failing case (with the
    ``^^^ FAILED ^^^^`` marker ci_test prints after it)."""
    lines = [f"# seeds crc32: {bench_cli.CRC32_SEED_SCHEME}\n"]
    for kind in "DZ":
        for op_a, op_b in (("N", "N"), ("T", "N")):
            for m, n, k in ((31, 32, 33), (33, 32, 31)):
                for i, mode in enumerate(MODES):
                    res = (1 + i) * 1e-17
                    if (kind, op_a, m, mode) == ("Z", "T", 33, "fp64_int8_12"):
                        res = 2.5e-15
                    lines.append(_row(kind, mode, op_a, op_b, m, n, k, res))
                    if res >= 1e-15:
                        lines.append("^^^ FAILED ^^^^\n")
    lines.append("   71 /    72 PASSED\n")
    logs, d = digest_tool.digest(lines, "NVIDIA H100 80GB HBM3, 700.00 W", "abc", 12.5,
                                 sizes=(31, 32, 33))
    assert logs["real"].splitlines() == [
        f"SET real-{m}x32x{k}-{ops} modes=9 failures=0 max_residual=9.000e-17"
        for ops in ("NN", "TN") for m, k in ((31, 33), (33, 31))
    ] + ["DONE kind=real cases=36 failures=0"]
    cx = logs["complex"].splitlines()
    assert len(cx) == 6 and cx[-3:] == [
        "FAIL complex-33x32x31-TN fp64_int8_12 residual=2.500e-15 max_rel=1.000e-16",
        "SET complex-33x32x31-TN modes=9 failures=1 max_residual=2.500e-15",
        "DONE kind=complex cases=36 failures=1",
    ]
    assert d["passed_line"] == "71 /    72 PASSED"
    assert d["device"] == "NVIDIA H100 80GB HBM3, 700.00 W" and d["commit"] == "abc"
    assert d["wall_seconds"] == 12.5 and d["sizes"] == [31, 32, 33] and d["modes"] == MODES
    assert d["seed_scheme"].startswith(bench_cli.CRC32_SEED_SCHEME)
    assert (d["real"]["sets"], d["real"]["cases"], d["real"]["failures"]) == (4, 36, 0)
    assert (d["complex"]["sets"], d["complex"]["cases"], d["complex"]["failures"]) == (4, 36, 1)
    assert d["complex"]["fail_lines"] == [cx[-3]]
    assert d["complex"]["worst_set_residual"] == 2.5e-15
    assert d["real"]["worst_set_residual"] == 9e-17
    assert d["complex"]["done"] == {"kind": "complex", "cases": 36, "failures": 1}
    assert d["real"]["per_set_max_residual"]["real-31x32x33-NN"] == 9e-17
    assert d["real"]["log"] == "torch_ci_full_real.log"


def test_crc32_gate_rows_equal_the_jax_runners():
    """``ci_test --seeds crc32`` on the CPU at size 17 draws the JAX
    runner's operands: two of its sets, scored by the JAX package's engine
    and oracle, give the same residuals."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_cli.run_ci_test((17,), "cpu", seeds="crc32")
    lines = out.getvalue().splitlines(True)
    assert rc == 0 and lines[-1].strip() == "72 /    72 PASSED"
    _, d = digest_tool.digest(lines, "cpu", "-", 0.0, sizes=(17,))
    assert (d["real"]["sets"], d["complex"]["sets"]) == (4, 4)
    rows = {(f[1], f[3], f[4], f[5]): f for f in (x.split(",") for x in lines[1:-1])}
    for kind, op_a, op_b in (("D", "N", "T"), ("Z", "T", "N")):
        a = generate_input("urand01", (17, 17), seed=zlib.crc32(f"17-17-{op_a}".encode()) % 2**31,
                           complex_=kind == "Z")
        b = generate_input("urand01", (17, 17), seed=zlib.crc32(f"17-17-{op_b}".encode()) % 2**31,
                           complex_=kind == "Z")
        cs = [np.asarray(oz.gemm(a, b, mode=mode, op_a=op_a, op_b=op_b)) for mode in MODES]
        errs = native.error_metrics_multi_native(cs, a if op_a == "N" else a.T.copy(),
                                                 b if op_b == "N" else b.T.copy())
        for mode, err in zip(MODES, errs):
            assert rows[(kind, mode, op_a, op_b)][9] == f"{err['relative_residual']:e}"


def test_unknown_seed_scheme_is_refused():
    with pytest.raises(ValueError, match="seeds"):
        bench_cli.run_ci_test((17,), "cpu", seeds="random")


def _committed():
    with open(os.path.join(ART, "torch_ci_full_digest.json")) as f:
        return json.load(f)


def test_committed_gate_evidence():
    d = _committed()
    assert d["device"].startswith("NVIDIA H100"), d["device"]
    assert d["sizes"] == [1023, 1024, 1025] and d["modes"] == MODES and d["threshold"] == 1e-15
    assert d["seed_scheme"].startswith(bench_cli.CRC32_SEED_SCHEME)
    assert d["passed_line"] == "1944 /  1944 PASSED"
    assert d["wall_seconds"] > 0
    for kind in ("real", "complex"):
        half = d[kind]
        assert half["sets"] == 108 and half["cases"] == 972, half
        assert half["failures"] == 0 and half["fail_lines"] == []
        assert half["done"] == {"kind": kind, "cases": 972, "failures": 0}
        assert half["worst_set_residual"] is not None
        assert half["worst_set_residual"] < d["threshold"]
        sets = half["per_set_max_residual"]
        assert sorted(sets) == sorted(
            f"{kind}-{m}x{n}x{k}-{a}{b}" for m in d["sizes"] for n in d["sizes"]
            for k in d["sizes"] for a in "NT" for b in "NT")
    assert d["real"]["cases"] + d["complex"]["cases"] == 1944


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_committed_digest_is_its_logs(kind):
    """Each half of the digest is what its committed log says."""
    d = _committed()
    with open(os.path.join(ART, d[kind]["log"])) as f:
        text = f.read()
    assert digest_tool.digest_log(text, d[kind]["log"]) == d[kind]
    for line in text.splitlines()[:-1]:
        assert line.startswith("SET ") and " modes=9 failures=0 max_residual=" in line, line


def _tpu_sets(kind):
    """The TPU's per-set maxima in the order its runner logged them."""
    with open(os.path.join(ART, f"ci_full_{kind}.log")) as f:
        return [(line.split()[1], float(line.split("max_residual=")[1]))
                for line in f if line.startswith("SET ")]


#: how many sets open the TPU's real log from an earlier engine (below)
TPU_EARLIER_REAL_SETS = 73


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_committed_gate_matches_the_tpus_sets(kind):
    """Same seeds, same engine bits, the same oracle: each set's largest
    residual equals the TPU's within 1 %, but for the first 73 sets of the
    TPU's real log.  Its runner resumes a log across runs, and those sets
    were written by an earlier engine: they read about 5 % below the
    card's, as one block at the head of the log, and
    ``test_the_jax_engine_gives_the_cards_first_real_set`` and
    ``test_the_jax_engine_gives_the_cards_earlier_real_sets`` show that
    the JAX package's engine of today gives the card's figures there."""
    card = _committed()[kind]["per_set_max_residual"]
    tpu = _tpu_sets(kind)
    assert len(tpu) == 108 and sorted(card) == sorted(key for key, _ in tpu)
    off = [i for i, (key, r) in enumerate(tpu)
           if card[key] != pytest.approx(r, rel=0.01, abs=0.0)]
    assert off == ([] if kind == "complex" else list(range(TPU_EARLIER_REAL_SETS))), off
    if kind == "real":
        assert tpu[0][0] == "real-1023x1023x1023-NN"
        for key, r in tpu[:TPU_EARLIER_REAL_SETS]:  # the earlier engine: 5 % below the card
            assert 1.04 < card[key] / r < 1.06, (key, card[key], r)


def test_the_jax_engine_gives_the_cards_first_real_set():
    """The TPU's real log opens with 3.663e-16 for real-1023x1023x1023-NN;
    the JAX package's engine (on the CPU) gives the card's figure: its
    largest residual, at fp64_int8_8, of the runner's operands."""
    m = n = k = 1023
    a = generate_input("urand01", (m, k), seed=zlib.crc32(f"{m}-{k}-N".encode()) % 2**31)
    b = generate_input("urand01", (k, n), seed=zlib.crc32(f"{k}-{n}-N".encode()) % 2**31)
    c = np.asarray(oz.gemm(a, b, mode="fp64_int8_8"))
    got = native.error_metrics_multi_native([c], a, b)[0]["relative_residual"]
    card = _committed()["real"]["per_set_max_residual"]["real-1023x1023x1023-NN"]
    assert float(f"{got:.3e}") == card
    assert _tpu_sets("real")[0] == ("real-1023x1023x1023-NN", 3.663e-16)


def _runner_case(key):
    """The JAX runner's operands of a gate set ``real-MxNxK-AB``."""
    dims, ops = key.split("-")[1:]
    m, n, k = (int(x) for x in dims.split("x"))
    op_a, op_b = ops
    a = generate_input("urand01", (m, k) if op_a == "N" else (k, m),
                       seed=zlib.crc32(f"{m}-{k}-{op_a}".encode()) % 2**31)
    b = generate_input("urand01", (k, n) if op_b == "N" else (n, k),
                       seed=zlib.crc32(f"{k}-{n}-{op_b}".encode()) % 2**31)
    return a, b, op_a, op_b


@pytest.mark.parametrize("index", [36, 55, 72, 73])
def test_the_jax_engine_gives_the_cards_earlier_real_sets(index):
    """More sets of the TPU's real log, each scored at its largest mode
    (fp64_int8_8) by the JAX package's engine on the CPU: in the earlier
    block (36, 55, 72, the last of it) today's engine gives the card's
    figure, not the TPU's; just after it (73) all three agree."""
    key, tpu_r = _tpu_sets("real")[index]
    a, b, op_a, op_b = _runner_case(key)
    c = np.asarray(oz.gemm(a, b, mode="fp64_int8_8", op_a=op_a, op_b=op_b))
    got = native.error_metrics_multi_native(
        [c], np.ascontiguousarray(a if op_a == "N" else a.T),
        np.ascontiguousarray(b if op_b == "N" else b.T))[0]["relative_residual"]
    card = _committed()["real"]["per_set_max_residual"][key]
    assert float(f"{got:.3e}") == card
    assert (tpu_r == card) == (index >= TPU_EARLIER_REAL_SETS), (key, tpu_r, card)
