"""The port's bench CLI (``ozimmu_tpu_torch.bench_cli``), its oracle and
timing helpers on the CPU: the g++-built oracle equals the JAX package's
(the same C++), ``ci_test`` prints the JAX package's rows, and the CLI
modes keep the reference's grammar and CSV schema.  Small shapes."""

import io
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu import bench_cli as jbench  # noqa: E402
from ozimmu_tpu import native  # noqa: E402
from ozimmu_tpu_torch import bench_cli, oracle  # noqa: E402
from ozimmu_tpu_torch.testing import effective_tflops, generate_input, sustained_run  # noqa: E402

HEADER = ["device", "gemm", "input", "mode", "opA", "opB", "m", "n", "k", "residual",
          "max_relative", "tflops"]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the oracle cannot be built here")


def _capture(fn, *args, **kw):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = fn(*args, **kw)
    finally:
        sys.stdout = old
    return rc, buf.getvalue()


@pytest.mark.parametrize("complex_", [False, True])
def test_oracle_equals_the_jax_packages(gxx, complex_):
    a = generate_input("exp_rand-2", (37, 53), seed=1, complex_=complex_)
    b = generate_input("exp_rand-2", (53, 29), seed=2, complex_=complex_)
    exact = a @ b
    cs = [exact, exact * (1 + 1e-15), exact + 1e-9, np.zeros_like(exact)]
    got = oracle.error_metrics_multi(cs, a, b)
    assert got == native.error_metrics_multi_native(cs, a, b)
    # the single-C entry sums rows in parallel: the same metrics up to the
    # order of its long-double reduction
    for c, want in zip(cs, got):
        one = oracle.error_metrics(c, a, b)
        for key in want:
            assert one[key] == pytest.approx(want[key], rel=1e-12, abs=0.0)
    assert got[-1] == {"relative_residual": 1.0, "max_relative_error": 1.0}


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("complex_", [False, True])
def test_multi_oracle_equals_the_jax_packages_over_slabs(gxx, complex_, threads):
    """130 rows are three slabs of the multi-C oracle (64, 64 and a partial
    2): its metrics equal the JAX package's one-thread loop exactly at any
    thread count, and a real call's rounded reference equals
    ``native.ref_gemm_native``."""
    a = generate_input("exp_rand-2", (130, 70), seed=3, complex_=complex_)
    b = generate_input("exp_rand-2", (70, 50), seed=4, complex_=complex_)
    exact = a @ b
    cs = [exact, exact * (1 + 1e-15), exact + 1e-9, exact.astype(np.complex64 if complex_
                                                                  else np.float32)]
    ref64 = None if complex_ else np.empty((130, 50))
    got = oracle.error_metrics_multi(cs, a, b, threads=threads, ref64=ref64)
    assert got == native.error_metrics_multi_native(cs, a, b)
    if not complex_:
        assert np.array_equal(ref64, native.ref_gemm_native(a, b))
    assert all(e["relative_residual"] > 0 for e in got[1:])


def test_oracle_rejects_bad_calls(gxx):
    a, b = np.ones((4, 5)), np.ones((5, 3))
    with pytest.raises(ValueError, match="shapes"):
        oracle.error_metrics(np.ones((3, 4)), a, b)
    with pytest.raises(ValueError, match="candidates"):
        oracle.error_metrics_multi([a @ b] * 33, a, b)
    with pytest.raises(ValueError, match="ref64"):
        oracle.error_metrics_multi([a @ b], a, b, ref64=np.empty((4, 4)))
    with pytest.raises(ValueError, match="ref64"):
        oracle.error_metrics_multi([(a @ b).astype(complex)], a, b, ref64=np.empty((4, 3)))


def test_ci_test_rows_equal_the_jax_packages(gxx):
    """All 72 rows of ``ci_test`` at size 33 (D and Z, four op pairs, nine
    modes) equal the JAX package's field by field, but for the device."""
    rc, out = _capture(bench_cli.run_ci_test, sizes=(33,), device="cpu")
    jrc, jout = _capture(jbench.run_ci_test, sizes=(33,))
    assert rc == jrc == 0
    rows = [line.split(",") for line in out.splitlines()]
    jrows = [line.split(",") for line in jout.splitlines()]
    assert len(rows) == len(jrows) == 73 and rows[-1] == jrows[-1]
    assert out.splitlines()[-1] == "   72 /    72 PASSED"
    for row, jrow in zip(rows[:-1], jrows[:-1]):
        assert row[0] == "cpu" and row[1:] == jrow[1:]
    assert {r[1] for r in rows[:-1]} == {"D", "Z"} and {r[3] for r in rows[:-1]} == {
        f"fp64_int8_{ns}" for ns in range(8, 17)}


def test_seq_and_exp2_sweeps(gxx):
    rc, out = _capture(bench_cli.main, ["urand01", "dgemm", "fp64_int8_9", "seq", "32", "64", "16",
                                        "--test-count", "0", "--device", "cpu"])
    lines = out.strip().splitlines()
    assert rc == 0 and lines[0].split(",") == HEADER
    rows = [line.split(",") for line in lines[1:]]
    assert [int(r[6]) for r in rows] == [32, 48, 64]
    assert all(float(r[9]) < 1e-15 and r[11] == "nan" and r[0] == "cpu" for r in rows)

    rc, out = _capture(bench_cli.main, ["exp_rand-2", "zgemm", "fp64_int8_8,fp64_int8_12", "exp2",
                                        "16", "64", "2", "--test-count", "2", "--ops", "NN,TC",
                                        "--device", "cpu"])
    rows = [line.split(",") for line in out.strip().splitlines()[1:]]
    assert rc == 0 and len(rows) == 3 * 2 * 2
    assert [(int(r[6]), r[3], r[4] + r[5]) for r in rows[:4]] == [
        (16, "fp64_int8_8", "NN"), (16, "fp64_int8_8", "TC"),
        (16, "fp64_int8_12", "NN"), (16, "fp64_int8_12", "TC")]
    assert all(r[1] == "Z" and float(r[11]) > 0 for r in rows)
    # op C is scored against the conjugate transpose: the residual passes
    assert all(float(r[9]) < 1e-13 for r in rows if r[3] == "fp64_int8_12")
    assert bench_cli._size_list("exp2", 3, 100, 1) == [3, 6, 12, 24, 48, 96]


def test_error_threshold_flags_a_failed_case(gxx):
    rc, out = _capture(bench_cli._run_case, "dgemm", "urand01", "fp64_int8_3", "N", "N",
                       24, 24, 24, 0, error_threshold=1e-15, device="cpu")
    assert rc == 1 and "^^^ FAILED ^^^^" in out


def test_large_products_are_scored_on_a_sampled_block(monkeypatch):
    """Above the oracle's size limit only a seeded block of C is scored;
    at or below it, all of C."""
    monkeypatch.setattr(bench_cli, "FULL_ORACLE_MAX_MACS", 20**3)
    monkeypatch.setattr(bench_cli, "SAMPLE", 8)
    a, b = np.arange(21 * 22.0).reshape(21, 22), np.ones((22, 23))
    cs, sa, sb = bench_cli._scored([a @ b], a, b)
    assert (cs[0].shape, sa.shape, sb.shape) == ((8, 8), (8, 22), (22, 8))
    np.testing.assert_array_equal(cs[0], sa @ sb)
    small = [a[:10] @ b[:, :20]], a[:10], b[:, :20]
    assert all(x is y for x, y in zip(bench_cli._scored(*small), small))


def test_matfile_and_raw_loaders(gxx, tmp_path):
    rng = np.random.default_rng(11)
    a = rng.uniform(size=(24, 40))
    b = rng.uniform(size=(40, 16))
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    rc, out = _capture(bench_cli.main, ["matfile", str(tmp_path / "a.npy"), str(tmp_path / "b.npy"),
                                        "fp64_int8_9,fp64_int8_12", "--device", "cpu"])
    lines = out.strip().splitlines()
    assert rc == 0 and lines[0].split(",") == HEADER and len(lines) == 3
    assert all(r.split(",")[2] == "matfile" and float(r.split(",")[9]) < 1e-15 for r in lines[1:])
    for dtype, cast in (("fp64", np.float64), ("fp32", np.float32)):
        pa, pb = tmp_path / f"a.{dtype}", tmp_path / f"b.{dtype}"
        np.asarray(a, cast, order="F").T.ravel().tofile(pa)  # column-major
        np.asarray(b, cast, order="F").T.ravel().tofile(pb)
        got = bench_cli.load_raw_matrix(str(pa), 24, 40, dtype)
        np.testing.assert_array_equal(got, jbench.load_raw_matrix(str(pa), 24, 40, dtype))
        rc, out = _capture(bench_cli.main, ["matfile_raw", str(pa), str(pb), "24", "40", "16",
                                            "--dtype", dtype, "fp64_int8_9", "--device", "cpu"])
        row = out.strip().splitlines()[1].split(",")
        assert rc == 0 and row[2] == f"matfile-{dtype}" and float(row[9]) < 1e-15
    bad = tmp_path / "x.bin"
    np.zeros(7, np.float64).tofile(bad)
    with pytest.raises(ValueError, match="expected"):
        bench_cli.load_raw_matrix(str(bad), 2, 4, "fp64")
    with pytest.raises(ValueError, match="dtype"):
        bench_cli.load_raw_matrix(str(bad), 7, 1, "int8")


def test_power_without_nvml_prints_na():
    """On the CPU there is no card to sample: watts and GFLOPS/W are n/a,
    and iters / avg_time / tflops are measured and consistent."""
    rc, out = _capture(bench_cli.main, ["power", "dgemm", "fp64_int8_8", "48", "--min-seconds",
                                        "0.3", "--device", "cpu"])
    m = re.search(r"^power,cpu,fp64_int8_8,m=n=k=48,iters=(\d+),avg_time=([0-9.eE+-]+)s,"
                  r"tflops=([0-9.eE+-]+),watts=n/a,gflops_per_w=n/a$", out.strip())
    assert rc == 0 and m, out
    iters, avg_time, tflops = int(m[1]), float(m[2]), float(m[3])
    assert iters > 0 and avg_time > 0
    np.testing.assert_allclose(tflops, 2 * 48**3 / avg_time / 1e12, rtol=2e-3)


def test_power_sampler_without_nvml(monkeypatch):
    import ctypes

    def missing(name, *args, **kwargs):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", missing)
    sampler = bench_cli._PowerSampler("cuda")
    sampler.start()
    assert sampler.stop() is None


def test_timing_helpers_measure_the_call():
    a = generate_input("urand01", (32, 48), seed=0)
    b = generate_input("urand01", (48, 16), seed=1)
    assert effective_tflops(a, b, "fp64_int8_9", 2, device="cpu") > 0
    az = generate_input("urand01", (32, 48), seed=2, complex_=True)
    bz = generate_input("urand01", (48, 16), seed=3, complex_=True)
    assert effective_tflops(az, bz, "dgemm", 2, device="cpu") > 0
    starts = []
    tflops, iters, avg = sustained_run(a, b, "sgemm", min_seconds=0.2, target_chunk_seconds=0.05,
                                       on_measure_start=lambda: starts.append(1), device="cpu")
    assert starts == [1] and iters > 0 and avg > 0
    np.testing.assert_allclose(tflops, 2 * 32 * 16 * 48 / avg / 1e12)


#: (dtype, resident, panel, block): real and complex, the host path and the
#: resident path with both panel kinds, at n = 64.  Block 16 gives four
#: steps; the complex resident cases take block 32 (two steps), because
#: each of the JAX CLI's complex step programs compiles for several seconds
HPL_CASES = [("d", "off", "host", 16), ("d", "on", "host", 16), ("d", "on", "device", 16),
             ("z", "off", "host", 16), ("z", "on", "host", 32), ("z", "on", "device", 32)]


@pytest.mark.parametrize("dtype,resident,panel,block", HPL_CASES)
def test_hpl_line_equals_the_jax_clis(monkeypatch, dtype, resident, panel, block):
    """``hpl`` and ``hpl --dtype z`` on the CPU return 0 and print the JAX
    CLI's line, field for field, apart from the device name, the time and
    the rate.  The residual is equal too on the host path, where both CLIs
    build the same matrix; the resident path makes its matrix on the device
    from each framework's own generator, so there the residuals only share
    the 1e-14 gate."""
    args = ["hpl", "fp64_int8_9", "64", "--block", str(block), "--panel", panel, "--dtype", dtype]
    rc, out = _capture(bench_cli.main, args + ["--resident", resident, "--device", "cpu"])
    monkeypatch.setenv("OZ_HPL_DEVICE_GEN", "1")  # the JAX CLI's on-device ZHPL matrix on the CPU
    jrc, jout = _capture(jbench.main, args + ["--device", resident])
    assert rc == jrc == 0
    row, jrow = out.strip().splitlines()[-1].split(","), jout.strip().splitlines()[-1].split(",")
    assert [f.split("=")[0] for f in row[2:]] == [f.split("=")[0] for f in jrow[2:]]
    fields, jfields = (dict(f.split("=") for f in r if "=" in f) for r in (row, jrow))
    rate = "gflops_x4" if dtype == "z" else "gflops"
    assert row[0] == jrow[0] == ("zhpl" if dtype == "z" else "hpl") and row[1] == "cpu"
    assert row[2] == jrow[2] == "fp64_int8_9"
    assert fields["resident"] == ("device" if resident == "on" else "host")
    assert fields["panel"] == (panel if resident == "on" else "host")
    for key in fields:
        if key not in ("factor_time", rate, "residual"):
            assert fields[key] == jfields[key], key
    assert float(fields["factor_time"].rstrip("s")) > 0 and float(fields[rate]) > 0
    assert float(fields["residual"]) < 1e-14 and float(jfields["residual"]) < 1e-14
    if resident == "off":
        assert fields["residual"] == jfields["residual"]


def test_hpl_options(monkeypatch):
    """``--profile`` appends the phases of a second, instrumented pass;
    ``--refine`` and ``--seed`` reach the solver; ``--resident auto`` is
    the host path on the CPU; a residual over the gate returns 1."""
    base = ["hpl", "fp64_int8_9", "64", "--block", "32", "--device", "cpu"]
    rc, out = _capture(bench_cli.main, base + ["--resident", "on", "--panel", "host",
                                               "--profile", "--warmup"])
    keys = [f.split("=")[0] for f in out.strip().split(",")[3:]]
    assert rc == 0 and keys[-3:] == ["device_update_s", "panel_host_s", "panel_pull_s"]
    rc, out = _capture(bench_cli.main, base + ["--resident", "on", "--panel", "device",
                                               "--profile", "--dtype", "z"])
    keys = [f.split("=")[0] for f in out.strip().split(",")[3:]]
    assert rc == 0 and keys[-2:] == ["device_update_s", "panel_device_s"]
    rc, out = _capture(bench_cli.main, base)
    assert rc == 0 and out.strip().endswith("resident=host,panel=host")
    rc3, out3 = _capture(bench_cli.main, ["hpl", "fp64_int8_3", "64", "--block", "32", "--device",
                                          "cpu", "--resident", "on", "--seed", "1"])
    rc3r, out3r = _capture(bench_cli.main, ["hpl", "fp64_int8_3", "64", "--block", "32",
                                            "--device", "cpu", "--resident", "on", "--seed", "1",
                                            "--refine", "3"])
    res = lambda o: float(dict(f.split("=") for f in o.strip().split(",")[3:])["residual"])  # noqa: E731
    assert rc3 == 1 and res(out3) >= 1e-14  # three digits alone do not reach the gate
    assert rc3r == 0 and res(out3r) < 1e-14 and "refine=3" in out3r
