"""The readers of the program's spans (``harness/spans.py`` and the
``*_host_us`` and ``solver_idle_ms`` metrics) on small synthetic Chrome
traces: self time, idle time under a span, both clipped to the window, and
nothing read where the program opened no ``oz.*`` span."""

import json
import os

import pytest

from conftest import BENCH_DIR, ROOT
from harness import readers, spans, spec
from harness.driver import Window
from harness.tracing import SPAN, Trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}


def _ua(name, ts, dur):
    return _ev("user_annotation", name, ts, dur)


#: two intercepted calls in a window [100, 1100]; the first call's
#: interceptor span opens before the window and is clipped at 100
CALLS = [
    _ua(SPAN, 100.0, 1000.0),
    # call 1: [50, 500]
    _ua("oz.intercept", 50.0, 450.0),
    _ua("oz.api", 120.0, 370.0),          # [120, 490]
    _ev("cpu_op", "aten::where", 125.0, 10.0),
    _ua("oz.engine", 150.0, 330.0),       # [150, 480]
    _ua("oz.split", 160.0, 40.0),         # [160, 200]
    _ua("oz.split", 210.0, 40.0),         # [210, 250]
    _ua("oz.recombine", 260.0, 100.0),    # [260, 360]
    _ua("oz.epilogue", 370.0, 60.0),      # [370, 430]
    # call 2: [600, 1000]
    _ua("oz.intercept", 600.0, 400.0),
    _ua("oz.api", 610.0, 380.0),          # [610, 990]
    _ua("oz.engine", 620.0, 360.0),       # [620, 980]
    _ua("oz.split", 630.0, 50.0),
    _ua("oz.split", 690.0, 50.0),
    _ua("oz.recombine", 750.0, 100.0),
    _ua("oz.epilogue", 860.0, 100.0),
    # a span wholly after the window: left out
    _ua("oz.intercept", 1200.0, 100.0),
    _ev("kernel", "void recombine_kernel<1, 128>(...)", 300.0, 200.0),
]


def _ctx(events, units):
    return readers.Context(Trace(events), units, [], Window(), None)


@pytest.mark.parametrize("metric,want", [
    # call 1: 450 - 50 clipped - api's 370 = 30; call 2: 400 - 380 = 20
    ("intercept_host_us.call", (30.0 + 20.0) / 2),
    ("api_host_us.call", (40.0 + 20.0) / 2),  # 370 - 330 (a torch op is no child); 380 - 360
    ("engine_host_us.call", (330.0 - 240.0 + 360.0 - 300.0) / 2),
    ("split_host_us.call", (80.0 + 100.0) / 2),
    ("recombine_host_us.call", (100.0 + 100.0) / 2),
    ("epilogue_host_us.call", (60.0 + 100.0) / 2),
])
def test_each_host_metric_is_its_spans_self_time_a_call(metric, want):
    assert spec.metric_reader(metric)(_ctx(CALLS, 2)) == pytest.approx(want)


def test_the_self_times_add_up_to_the_interceptors_spans():
    t = Trace(CALLS)
    total = sum(spans.self_us(t, n) for n in ("oz.intercept", "oz.api", "oz.engine", "oz.split",
                                              "oz.recombine", "oz.epilogue"))
    assert total == pytest.approx((500.0 - 100.0) + 400.0)


def test_a_span_inside_a_span_of_its_own_name_is_its_child():
    events = [_ua(SPAN, 0.0, 100.0), _ua("oz.engine", 10.0, 80.0), _ua("oz.engine", 20.0, 30.0),
              _ua("oz.split", 25.0, 10.0), _ua("oz.split", 60.0, 10.0)]
    t = Trace(events)
    # the outer 80 less the inner engine's 30 and the second split's 10;
    # the inner 30 less its split's 10
    assert spans.self_us(t, "oz.engine") == pytest.approx(40.0 + 20.0)


HPL = [
    _ua(SPAN, 0.0, 1000.0),
    _ua("oz.lu_factor", 10.0, 790.0),     # [10, 800]
    _ua("oz.lu.panel", 20.0, 100.0),      # [20, 120]
    _ua("oz.lu.pivots", 120.0, 30.0),     # [120, 150]
    _ua("oz.lu.update", 160.0, 600.0),    # [160, 760]
    _ua("oz.engine", 170.0, 300.0),       # [170, 470]
    _ua("oz.lu_solve", 820.0, 100.0),     # [820, 920]
    _ev("cuda_runtime", "cudaDeviceSynchronize", 930.0, 60.0),
    _ev("kernel", "getrf", 30.0, 80.0),         # busy [30, 110]
    _ev("kernel", "recombine_kernel", 180.0, 200.0),   # [180, 380]
    _ev("kernel", "epilogue_kernel", 400.0, 50.0),     # [400, 450]
    _ev("gpu_memcpy", "Memcpy HtoD", 500.0, 250.0),    # [500, 750]
    _ev("kernel", "lu_solve", 850.0, 50.0),            # [850, 900]
]


def test_solver_idle_counts_the_gaps_the_solvers_host_work_opens():
    ctx = _ctx(HPL, 2)
    # gaps: [0, 30] (no solver span at 0), [110, 180] (panel), [380, 400]
    # and [450, 500] (an engine product), [750, 850] (update, then solve),
    # [900, 1000] (the solve)
    assert spans.gaps(ctx.trace) == [(0.0, 30.0), (110.0, 180.0), (380.0, 400.0),
                                     (450.0, 500.0), (750.0, 850.0), (900.0, 1000.0)]
    want_ms = (70.0 + 100.0 + 100.0) / 1e3 / 2
    assert spec.metric_reader("solver_idle_ms.hpl")(ctx) == pytest.approx(want_ms)


def test_solver_idle_is_clipped_to_the_window():
    events = [_ua(SPAN, 100.0, 300.0), _ua("oz.lu_factor", 0.0, 1000.0),
              _ev("kernel", "k", 50.0, 100.0), _ev("kernel", "k", 200.0, 50.0)]
    # in [100, 400]: busy [200, 250] alone (the kernel starting at 50 is
    # not the window's); the gaps [100, 200] and [250, 400] open inside the
    # factor's span, which is clipped to the window
    ctx = _ctx(events, 1)
    assert spec.metric_reader("solver_idle_ms.hpl")(ctx) == pytest.approx(250e-3)


NO_SPANS = [e for e in CALLS + HPL if not e["name"].startswith("oz.")]


@pytest.mark.parametrize("metric", ["intercept_host_us.call", "api_host_us.call",
                                    "engine_host_us.call", "split_host_us.call",
                                    "recombine_host_us.call", "epilogue_host_us.call",
                                    "solver_idle_ms.hpl"])
def test_a_trace_without_the_programs_spans_reads_nothing(metric):
    events = [e for e in NO_SPANS if e["name"] != SPAN] + [_ua(SPAN, 0.0, 1100.0)]
    assert spec.metric_reader(metric)(_ctx(events, 2)) is None


def test_the_new_metrics_are_program_spans_of_their_cells():
    """The seven metrics are in BENCHMARK.json as program spans, each with
    its file, listed for the cell whose traced run finds their spans."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    host = ["intercept", "api", "engine", "split", "recombine", "epilogue"]
    want = {f"{h}_host_us.call": ("call_ms_p95", "dgemm-1024-intercept") for h in host}
    want["solver_idle_ms.hpl"] = ("hpl_gflops", "hpl-45056-nb1024")
    for name, (moves, cell) in want.items():
        m = per_layer[name]
        assert m["source"] == "program_span" and m["moves"] == moves and m["workloads"] == [cell]
        stem = name.partition(".")[0]
        assert spec.path_of("metrics", name) == os.path.join(BENCH_DIR, "metrics", f"{stem}.py")
