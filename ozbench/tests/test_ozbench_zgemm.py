"""The ZGEMM cell (``zgemm-8192-ns9-abc``) at sizes that a test can hold:
``correct`` passes the program and fails the control, untraced and
traced; the counts of the complex split's and fold's rooflines; the
driver's work and products.  The cell's CPU sizes are set here, on a copy
of the benchmark (``conftest.copy_benchmark``)."""

import json
import os
import types

import pytest

import ozimmu_tpu_torch as ozt
from conftest import copy_benchmark, run_small, traced_on_the_card
from harness import driver, roofline, spec, zroofline

CELL = "zgemm-8192-ns9-abc"
TRAFFIC = "traffic/zgemm-abc-8192.json"
SMALL = {"m": 64, "n": 48, "k": 96, "soak_s": 0.05, "trace_lead_s": 0.05, "sample_entries": 256}


@pytest.fixture
def small_z(tmp_path):
    """A copy of the benchmark with the ZGEMM cell at CPU sizes."""
    root = copy_benchmark(str(tmp_path))
    path = os.path.join(root, "ozbench", TRAFFIC)
    with open(path) as f:
        d = json.load(f)
    d.update(SMALL)
    with open(path, "w") as f:
        json.dump(d, f)
    return root


def _control(a, b, *, alpha, beta, c, **_):
    from reference import zgemm

    return zgemm.control(a, b, c, alpha, beta)


@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes(small_z, trace):
    r = run_small(small_z, CELL, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) >= {"entry_err", "rowsum_err"}
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if not trace:
        assert set(r["metrics"]) == {"gemm_tflops", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_control_fails(small_z, trace):
    r = run_small(small_z, CELL, trace=trace, program=types.SimpleNamespace(gemm=_control))
    assert r["correct"] is False and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_an_answer_with_one_entry_altered_is_caught(small_z):
    def altered(*args, **kwargs):
        out = ozt.gemm(*args, **kwargs).clone()
        out[17, 5] += 2.0**-20 * out[17, 5].imag * 1j
        return out

    r = run_small(small_z, CELL, program=types.SimpleNamespace(gemm=altered))
    assert r["correct"] is False and r["checks"]["rowsum_err"]["value"] > 1e-15


def test_the_split_counts_each_part_once():
    m, n, k, ns = 8192, 8192, 8192, 9
    passes = [roofline.Product(1, m, n, k, ns, beta=True)] * zroofline.PASSES
    want = (2 * (m * k + k * n) * (8 + ns) + 4 * 2 * (m + n)) / roofline.HBM_BYTES_PER_S
    assert sum(map(zroofline.zsplit_least_s, passes)) == pytest.approx(want)
    # two real products' worth: A's and B's two parts, not four of each
    assert sum(map(zroofline.zsplit_least_s, passes)) == \
        pytest.approx(2 * roofline.split_least_s(passes[0]))
    assert want == pytest.approx(1.3622e-3, rel=1e-4)


def test_the_fold_reads_80_bytes_an_element_with_beta():
    m = n = 8192
    with_c = roofline.Product(1, m, n, 8192, 9, beta=True)
    want = (80 * m * n + 4 * 4 * (m + n)) / roofline.HBM_BYTES_PER_S
    assert zroofline.PASSES * zroofline.zfold_least_s(with_c) == pytest.approx(want)
    assert want == pytest.approx(1.6027e-3, rel=1e-4)
    without = with_c._replace(beta=False)
    assert zroofline.zfold_bytes(with_c) - zroofline.zfold_bytes(without) == 16 * m * n


def test_the_driver_counts_8mnk_and_four_passes(small_z):
    import torch

    bench = os.path.join(small_z, "ozbench")
    cell = spec.find_cell(CELL, small_z, bench)
    drv = driver.make(cell.config, cell.traffic, 2**31 + 11, torch.device("cpu"), ozt, bench)
    m, n, k = SMALL["m"], SMALL["n"], SMALL["k"]
    assert drv.work() == 8 * m * n * k
    assert drv.products() == [roofline.Product(1, m, n, k, 9, beta=True)] * 4
    drv.prepare()
    assert drv.a.dtype == drv.b.dtype == drv.c0.dtype == torch.complex128
    assert drv.alpha == 0.75 - 0.5j and drv.beta == -0.25 + 0.5j
    assert float(drv.a.real.min()) >= 0 and float(drv.a.imag.max()) < 1


def test_the_cells_metrics_have_readers():
    c = spec.find_cell(CELL)
    assert [m["name"] for m in c.end_to_end] == ["gemm_tflops", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "recombine_roofline.complex", "engine_roofline.complex", "zsplit_roofline.complex",
        "zfold_roofline.complex", "zlayout_ms.complex", "device_idle_share.complex",
        "sm_clock_mhz.complex"}
    assert c.limits == {"entry_err": 1e-14, "rowsum_err": 1e-15}


@pytest.mark.cuda
def test_the_traced_run_on_the_card_reads_every_metric(small_z, card):
    r = traced_on_the_card(small_z, CELL, seed=2**31 + 43)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["engine_shortfall_pct"]["value"] == 0.0
    assert set(r["metrics"]) == {m["name"] for m in spec.find_cell(CELL).per_layer}
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
