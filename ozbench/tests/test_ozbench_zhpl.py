"""The ZHPL cell (``zhpl-24576-nb1024``) at sizes that a test can hold:
``correct`` passes the program and fails the control and a solution moved
in one entry, untraced and traced; the driver's work, products and step
check; the copy and panel readers' split of a trace; the reference's
imports.  The cell's CPU sizes are set here, on a copy of the benchmark
(``conftest.copy_benchmark``)."""

import ast
import json
import os
import types

import pytest
import torch

import ozimmu_tpu_torch as ozt
from conftest import BENCH_DIR, copy_benchmark, run_small, traced_on_the_card
from harness import driver, readers, roofline, spec
from harness.driver import Window
from harness.tracing import SPAN, Trace

CELL = "zhpl-24576-nb1024"
CONFIG = "configs/zhpl-n24576-nb1024.json"
TRAFFIC = "traffic/zhpl-solves.json"
SMALL_CONFIG = {"N": 192, "NB": 64}
SMALL_TRAFFIC = {"soak_s": 0.05, "trace_lead_s": 0.05}


def _update(root, rel, changes):
    path = os.path.join(root, "ozbench", rel)
    with open(path) as f:
        d = json.load(f)
    d.update(changes)
    with open(path, "w") as f:
        json.dump(d, f)


@pytest.fixture
def small_z(tmp_path):
    """A copy of the benchmark with the ZHPL cell at CPU sizes."""
    root = copy_benchmark(str(tmp_path))
    _update(root, CONFIG, SMALL_CONFIG)
    _update(root, TRAFFIC, SMALL_TRAFFIC)
    return root


def _program(lu_factor=None, lu_solve=None):
    return types.SimpleNamespace(linalg=types.SimpleNamespace(
        lu_factor=lu_factor or ozt.linalg.lu_factor, lu_solve=lu_solve or ozt.linalg.lu_solve))


def _control_solve(fac, b):
    from reference import zhpl

    return zhpl.control(fac, b)


def _assert_caught(r):
    assert r["correct"] is False and r["failed"] >= 1
    assert r["checks"]["hpl_resid"]["value"] > r["checks"]["hpl_resid"]["limit"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes(small_z, trace):
    r = run_small(small_z, CELL, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["hpl_resid"]["value"] < 1.0
    assert r["checks"]["hpl_resid"]["limit"] == 16.0
    if not trace:
        assert set(r["metrics"]) == {"hpl_gflops", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_the_control_fails(small_z, trace):
    # the control solves from the pristine A in complex64: the factor the
    # program is handed back is A itself
    prog = _program(lu_factor=lambda a, **_: a, lu_solve=_control_solve)
    _assert_caught(run_small(small_z, CELL, trace=trace, program=prog))


def test_a_solution_moved_in_one_entry_is_caught(small_z):
    def moved(fac, b):
        x = ozt.linalg.lu_solve(fac, b).clone()
        j = int(x.abs().argmax())
        x[j] *= 1 + 2.0**-20
        return x

    _assert_caught(run_small(small_z, CELL, program=_program(lu_solve=moved)))


def _driver(root, program=ozt, seed=2**31 + 11):
    bench = os.path.join(root, "ozbench")
    cell = spec.find_cell(CELL, root, bench)
    return driver.make(cell.config, cell.traffic, seed, torch.device("cpu"), program, bench)


def test_the_driver_counts_four_passes_an_lu_product_and_4_hpl_flops(small_z):
    drv = _driver(small_z)
    n, nb = SMALL_CONFIG["N"], SMALL_CONFIG["NB"]
    lu = roofline.lu_products(n, nb, 9)
    assert drv.products() == [p for p in lu for _ in range(4)]
    assert len(drv.products()) == 4 * 2 * (n // nb - 1)
    assert drv.work() == 4 * roofline.hpl_flops(n)
    drv.prepare()
    assert drv.a.dtype == drv.b.dtype == torch.complex128
    assert drv.a.shape == (n, n) and drv.b.shape == (n,)
    for part in (drv.a.real, drv.a.imag, drv.b.real, drv.b.imag):
        assert -0.5 <= float(part.min()) and float(part.max()) < 0.5
    assert drv.ran == {("complex128", "device"): n // nb}


def test_the_operands_are_the_seeds():
    gen = spec.load("operands", "uniform_pm_half_complex")

    def made(seed):
        return gen.make((8, 8), torch.Generator().manual_seed(seed), torch.device("cpu"))

    assert torch.equal(made(2**31 + 3), made(2**31 + 3))
    assert not torch.equal(made(2**31 + 3), made(2**31 + 4))


def test_a_solve_that_is_not_the_resident_complex_lu_is_refused(small_z):
    # host panels: the step counter keys the steps by their panel kind
    host = _program(lu_factor=lambda a, **kw: ozt.linalg.lu_factor(a, **{**kw, "panel": "host"}))
    host.linalg.LU_STEPS = ozt.linalg.LU_STEPS
    with pytest.raises(RuntimeError, match="not the resident complex LU"):
        _driver(small_z, host).prepare()
    # a program without the counter (an older one) is not checked
    drv = _driver(small_z, _program())
    drv.prepare()
    assert drv.ran is None


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


COPY = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(...)")
COMPLEX = "void at::native::vectorized_elementwise_kernel<4, at::native::complex_kernel_cuda(...)>"
EVENTS = [
    _ev("user_annotation", SPAN, 0.0, 1000.0),
    _ev("kernel", COPY, 10.0, 30.0),
    _ev("kernel", COMPLEX, 50.0, 20.0),
    _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 80.0, 40.0),
    _ev("kernel", "void getrf_pivot<getrf_params_<c10::complex<double>, 512> >(...)", 130.0, 60.0),
    _ev("kernel", "void trsm_left_kernel<c10::complex<double>, 256, 4>(...)", 200.0, 15.0),
    _ev("kernel", "void at::native::index_elementwise_kernel<128, 4>(...)", 220.0, 5.0),
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 230.0, 2.0),
    _ev("kernel", "void (anonymous namespace)::recombine_kernel<2, 96, 8, 2, 2>(...)", 240.0,
        500.0),
    _ev("kernel", "(anonymous namespace)::zfold_kernel(...)", 750.0, 80.0),
    _ev("kernel", "void (anonymous namespace)::split_rows_kernel<16, true, 7>(...)", 840.0, 10.0),
]


def test_copy_and_panel_time_split_a_trace_without_overlap():
    ctx = readers.Context(Trace(EVENTS), 2, [], Window(), None)
    copy = spec.metric_reader("zcopy_ms.zhpl")(ctx)
    panel = spec.metric_reader("zpanel_ms.zhpl")(ctx)
    # the copy kernel, torch.complex's kernel and the DtoD memcpy
    assert copy == pytest.approx(1e3 * 90e-6 / 2)
    # getrf, trsm, the swap's index kernel and the pivots' read-back
    assert panel == pytest.approx(1e3 * 82e-6 / 2)
    # together they are panel_ms's library time: nothing counted twice or lost
    assert copy + panel == pytest.approx(spec.metric_reader("panel_ms.hpl")(ctx))
    empty = readers.Context(Trace(EVENTS[:1]), 1, [], Window(), None)
    assert spec.metric_reader("zcopy_ms.zhpl")(empty) is None
    assert spec.metric_reader("zpanel_ms.zhpl")(empty) is None


def test_the_reference_imports_neither_the_program_nor_jax():
    path = os.path.join(BENCH_DIR, "reference", "zhpl.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
    assert names == {"__future__", "typing", "torch"}
    assert not names & {"ozimmu_tpu_torch", "ozimmu_tpu", "jax", "jaxlib"}


def test_the_cells_metrics_have_readers():
    c = spec.find_cell(CELL)
    assert c.chips == 1
    assert [m["name"] for m in c.end_to_end] == ["hpl_gflops", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "recombine_roofline.zhpl", "zfold_roofline.zhpl", "zsplit_roofline.zhpl",
        "zcopy_ms.zhpl", "zpanel_ms.zhpl", "solver_idle_ms.zhpl", "device_idle_share.zhpl",
        "sm_clock_mhz.zhpl"}
    assert all(m["moves"] == "hpl_gflops" for m in c.per_layer)
    assert c.limits == {"hpl_resid": 16.0}
    assert c.config["dtype"] == "complex128" and c.config["panel"] == "device"
    assert c.config["N"] % c.config["NB"] == 0 and c.config["reduced"] == ["N"]


@pytest.mark.cuda
def test_the_traced_run_on_the_card_reads_every_metric(small_z, card):
    _update(small_z, CONFIG, {"N": 2048, "NB": 512})
    r = traced_on_the_card(small_z, CELL, seed=2**31 + 43)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["engine_shortfall_pct"]["value"] == 0.0
    assert set(r["metrics"]) == {m["name"] for m in spec.find_cell(CELL).per_layer}
    for name, m in r["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
