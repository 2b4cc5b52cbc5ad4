"""The AUTO cell (``dgemm-8192-exprand-auto``) at sizes that a test can
hold: ``correct`` passes the program and fails the control and a mode one
below the rule's; the driver takes ns from the program's counter of AUTO
decisions and refuses a program without one; the ``exp_rand-2`` operands
follow their law; the estimator's three readers on a synthetic trace.
The cell's CPU sizes are set here, on a copy of the benchmark
(``conftest.copy_benchmark``)."""

import json
import math
import os
import types

import pytest
import torch

import ozimmu_tpu_torch as ozt
from conftest import copy_benchmark, run_small, traced_on_the_card
from harness import autoroofline, driver, readers, roofline, spec
from harness.driver import Window
from harness.tracing import SPAN, Trace
from ozimmu_tpu_torch.core import api
from ozimmu_tpu_torch.types import ComputeMode

CELL = "dgemm-8192-exprand-auto"
TRAFFIC = "traffic/dgemm-auto-8192-exprand2.json"
SMALL = {"m": 48, "n": 40, "k": 1024, "soak_s": 0.05, "trace_lead_s": 0.05,
         "sample_entries": 256}


@pytest.fixture
def small_auto(tmp_path):
    """A copy of the benchmark with the AUTO cell at CPU sizes."""
    root = copy_benchmark(str(tmp_path))
    path = os.path.join(root, "ozbench", TRAFFIC)
    with open(path) as f:
        d = json.load(f)
    d.update(SMALL)
    with open(path, "w") as f:
        json.dump(d, f)
    return root


def _driver(root, program=ozt, seed=2**31 + 11):
    bench = os.path.join(root, "ozbench")
    cell = spec.find_cell(CELL, root, bench)
    return driver.make(cell.config, cell.traffic, seed, torch.device("cpu"), program, bench)


@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes(small_auto, trace):
    r = run_small(small_auto, CELL, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) >= {"entry_err", "rowsum_err", "auto_mode_err"}
    assert r["checks"]["auto_mode_err"]["value"] == 0.0
    if not trace:
        assert set(r["metrics"]) == {"gemm_tflops", "setup_s"}


def test_the_control_fails(small_auto):
    from reference import gemm as ref_gemm

    prog = types.SimpleNamespace(**{**vars(ozt), "gemm": lambda a, b, **_: ref_gemm.control(a, b)})
    r = run_small(small_auto, CELL, program=prog)
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["entry_err"]["value"] > r["checks"]["entry_err"]["limit"]
    # the control makes no AUTO decision
    assert r["checks"]["auto_mode_err"]["value"] == 1.0
    drv = _driver(small_auto)
    drv.prepare()
    assert drv.control()["auto_mode_err"] == 1.0


def test_a_mode_one_below_the_rules_is_caught(small_auto, monkeypatch):
    from reference import auto as ref_auto

    drv = _driver(small_auto)
    drv.prepare()
    want = ref_auto.mode(drv.a, drv.b, drv.cfg["auto_threshold"])
    below = ComputeMode.from_num_split(int(want.rsplit("_", 1)[1]) - 1)
    monkeypatch.setattr(api, "_auto_mode_select_core", lambda *args, **kw: below)
    r = run_small(small_auto, CELL)
    assert r["correct"] is False
    assert r["checks"]["auto_mode_err"]["value"] == 1.0


def test_the_driver_takes_ns_from_the_programs_choices(small_auto, capsys):
    from reference import auto as ref_auto

    drv = _driver(small_auto)
    drv.prepare()
    want = ref_auto.mode(drv.a, drv.b, 1e-4)
    assert drv.cfg["auto_threshold"] == 1e-4 and drv.handle.avg_mantissa_loss_threshold == 1e-4
    assert drv.ns == roofline.num_split(want) == 12
    assert drv.decisions() == {want: 1}
    m, n, k = SMALL["m"], SMALL["n"], SMALL["k"]
    assert drv.products() == [roofline.Product(1, m, n, k, 12)]
    assert drv.work() == 2 * m * n * k
    out = drv.run_units(2)
    nums = drv.judge(1, out)
    assert set(nums) == {"entry_err", "rowsum_err", "auto_mode_err"}
    assert nums["auto_mode_err"] == 0.0 and drv.decisions() == {want: 3}
    err = capsys.readouterr().err
    assert "ns 11 " in err and "ns 12 " in err and f"its mode {want}" in err


def test_a_program_without_the_counter_is_refused_at_once(small_auto):
    calls = []
    prog = types.SimpleNamespace(gemm=lambda *a, **kw: calls.append(1))
    with pytest.raises(RuntimeError, match="AUTO_CHOICES"):
        _driver(small_auto, program=prog).prepare()
    assert calls == []


def test_the_exp_rand_2_operands_follow_their_law():
    """(u - 0.5)·exp(2z): log|x| = log|u - 0.5| + 2z, the first uniform
    in log 0.5 less an exponential of mean 1 (variance 1), so log|x| has
    mean log 0.5 - 1 and variance 4 + 1; the signs are even."""
    make = spec.load("operands", "exp_rand-2").make
    x = make((400, 500), torch.Generator().manual_seed(2**31 + 5), torch.device("cpu"))
    assert x.dtype == torch.float64
    logs = x.abs().log()
    assert float(logs.mean()) == pytest.approx(math.log(0.5) - 1, abs=0.02)
    assert float(logs.var()) == pytest.approx(5.0, rel=0.02)
    assert float((x > 0).double().mean()) == pytest.approx(0.5, abs=0.005)
    # many binades: about 15 between the 1st and the 99th percentile, and
    # more than 30 between the largest and the smallest of 200,000
    q = torch.quantile(logs[:200].reshape(-1), torch.tensor([0.01, 0.99], dtype=torch.float64))
    normal = 2 * 2.326 * math.sqrt(5) / math.log(2)
    assert float(q[1] - q[0]) / math.log(2) == pytest.approx(normal, rel=0.05)
    assert float(logs.max() - logs.min()) / math.log(2) > 30


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


#: two AUTO calls in a window [100, 1100]
EVENTS = [
    _ev("user_annotation", SPAN, 100.0, 1000.0),
    _ev("user_annotation", "oz.api", 100.0, 400.0),
    _ev("user_annotation", "oz.auto", 110.0, 150.0),          # [110, 260]
    _ev("user_annotation", "oz.engine", 280.0, 200.0),
    _ev("user_annotation", "oz.api", 600.0, 400.0),
    _ev("user_annotation", "oz.auto", 600.0, 100.0),          # [600, 700]
    _ev("kernel", "void at::native::vectorized_elementwise_kernel<4, ...>(...)", 120.0, 20.0),
    _ev("kernel", "void at::native::reduce_kernel<512, 1, ...>(...)", 150.0, 30.0),
    _ev("kernel", "void at::cuda::kernelHistogram1D<long, ...>(...)", 190.0, 10.0),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 205.0, 5.0),
    _ev("kernel", "void (anonymous namespace)::split_rows_kernel<16>(...)", 300.0, 40.0),
    _ev("kernel", "void (anonymous namespace)::recombine_kernel<2, 256>(...)", 340.0, 250.0),
    _ev("kernel", "void at::native::elementwise_kernel<128, 2, ...>(...)", 610.0, 40.0),
    _ev("kernel", "void (anonymous namespace)::mantissa_loss_kernel(...)", 660.0, 20.0),
    _ev("kernel", "void (anonymous namespace)::recombine_kernel<2, 256>(...)", 720.0, 300.0),
]


def _ctx(units=2, products=None):
    p = roofline.Product(1, 1024, 1024, 1024, 12)
    return readers.Context(Trace(EVENTS), units, [p] * units if products is None else products,
                           Window(), None)


def test_auto_ms_reads_the_estimators_kernels_by_name(capsys):
    # 20 + 30 + 10 + 40 + 20 µs of kernels over two calls; the copy is no kernel
    assert spec.metric_reader("auto_ms.exprand")(_ctx()) == pytest.approx(1e3 * 120e-6 / 2)
    assert "auto_ms: 2.5 launches a unit" in capsys.readouterr().err
    empty = readers.Context(Trace(EVENTS[:6]), 2, [], Window(), None)
    assert spec.metric_reader("auto_ms.exprand")(empty) is None


def test_auto_roofline_is_a_and_b_read_once_over_the_estimators_time():
    p = roofline.Product(1, 1024, 1024, 1024, 12)
    assert autoroofline.estimator_bytes(p) == 8 * 2 * 1024**2
    want = 100 * 2 * (8 * 2 * 1024**2 / roofline.HBM_BYTES_PER_S) / 120e-6
    assert spec.metric_reader("auto_roofline.exprand")(_ctx()) == pytest.approx(want)
    assert spec.metric_reader("auto_roofline.exprand")(_ctx(products=[])) is None
    # 8192² operands: 1.07 GB, 0.32 ms at the HBM peak
    big = roofline.Product(1, 8192, 8192, 8192, 12)
    assert autoroofline.estimator_least_s(big) == pytest.approx(0.3205e-3, rel=1e-3)


def test_auto_idle_ms_reads_the_gaps_that_open_inside_oz_auto():
    # gaps [100, 120], [140, 150], [180, 190], [200, 205], [210, 300],
    # [590, 610], [650, 660], [680, 720], [1020, 1100]; those that open
    # inside oz.auto ([110, 260], [600, 700]): 10 + 10 + 5 + 90 + 10 + 40 µs
    assert spec.metric_reader("auto_idle_ms.exprand")(_ctx()) == pytest.approx(165e-3 / 2)
    no_span = [e for e in EVENTS if e["name"] != "oz.auto"]
    ctx = readers.Context(Trace(no_span), 2, [], Window(), None)
    assert spec.metric_reader("auto_idle_ms.exprand")(ctx) is None


def test_the_cells_metrics_have_readers():
    c = spec.find_cell(CELL)
    assert [m["name"] for m in c.end_to_end] == ["gemm_tflops", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "auto_ms.exprand", "auto_roofline.exprand", "auto_idle_ms.exprand",
        "recombine_roofline.exprand", "engine_roofline.exprand", "device_idle_share.exprand",
        "sm_clock_mhz.exprand"}
    assert c.limits == {"entry_err": 1e-14, "rowsum_err": 1e-15, "auto_mode_err": 1e-6}
    assert c.config["mode"] == "fp64_int8_auto" and c.config["operands"] == "exp_rand-2"


@pytest.mark.cuda
def test_the_traced_run_on_the_card_reads_every_metric(small_auto, card):
    r = traced_on_the_card(small_auto, CELL, seed=2**31 + 47)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["engine_shortfall_pct"]["value"] == 0.0
    assert r["checks"]["auto_mode_err"]["value"] == 0.0
    assert set(r["metrics"]) == {m["name"] for m in spec.find_cell(CELL).per_layer}
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
