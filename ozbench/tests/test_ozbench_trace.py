"""The trace reader on a small synthetic Chrome trace."""

import pytest

from harness import readers, roofline, spec
from harness.driver import Window
from harness.tracing import SPAN, Trace


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    # the opening launches' kernels, before the span: left out
    _ev("kernel", "add_kernel", 10.0, 1.0),
    _ev("user_annotation", SPAN, 100.0, 1000.0),
    _ev("cpu_op", "aten::matmul", 100.0, 900.0),
    _ev("cpu_op", "aten::copy_", 150.0, 40.0),
    _ev("cuda_runtime", "cudaStreamSynchronize", 700.0, 300.0),
    _ev("kernel", "void split_rows_kernel<7>(...)", 200.0, 50.0),
    _ev("kernel", "void exponent_rows_kernel(...)", 240.0, 30.0),  # overlaps the split
    _ev("kernel", "void recombine_kernel<2, 256>(...)", 300.0, 400.0),
    _ev("kernel", "void epilogue_kernel<false>(...)", 750.0, 50.0),
    _ev("gpu_memcpy", "Memcpy DtoH", 1010.0, 20.0),
]


def test_window_busy_and_idle_share():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1000e-6)
    # busy: [200, 270] (split and exponent joined), [300, 700], [750, 800], [1010, 1030]
    assert t.busy() == [(200.0, 270.0), (300.0, 700.0), (750.0, 800.0), (1010.0, 1030.0)]
    assert t.busy_s == pytest.approx(540e-6)
    assert t.idle_share() == pytest.approx(46.0)


def test_kernel_sums_by_pattern():
    t = Trace(EVENTS)
    assert t.device_seconds(r"recombine_kernel") == pytest.approx(400e-6)
    assert t.device_seconds(r"exponent_(rows|cols)_kernel|split_(rows|tiles)_kernel") == \
        pytest.approx(80e-6)
    assert t.device_seconds() == pytest.approx(530e-6)  # kernels only, overlaps counted
    ports = spec.metric_reader("panel_ms.hpl").__globals__["PORT_KERNELS"]
    assert t.device_seconds(exclude=ports, cats=("kernel", "gpu_memcpy")) == pytest.approx(20e-6)


def test_panel_time_leaves_out_a_renamed_kernel_of_the_port():
    events = EVENTS + [
        _ev("kernel", "void (anonymous namespace)::fused_engine_kernel<3>(...)", 820.0, 100.0),
        _ev("kernel", "void getrf_pivot<getrf_params_<double, 512> >(...)", 930.0, 30.0),
        _ev("kernel", "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize32x64x32", 965.0, 10.0),
    ]
    ctx = readers.Context(Trace(events), 2, [], Window(), None)
    # the copy (20), cuSOLVER's panel (30) and cuBLAS's f64 GEMM (10), per unit
    assert spec.metric_reader("panel_ms.hpl")(ctx) == pytest.approx(1e3 * 60e-6 / 2)


def test_engine_shortfall_counts_products_without_an_engine_launch():
    p = roofline.Product(1, 64, 64, 64, 9)
    one = Trace(EVENTS)
    assert one.launches(readers.ENGINE_KERNELS) == 1
    assert readers.engine_shortfall_pct(readers.Context(one, 1, [p], Window(), None)) == 0.0
    # four products traced, one launch: three ran elsewhere
    assert readers.engine_shortfall_pct(readers.Context(one, 4, [p] * 4, Window(), None)) == 75.0
    # a float64 library GEMM in the engine's place is no engine launch
    native = Trace([e for e in EVENTS if "recombine" not in e["name"]]
                   + [_ev("kernel", "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n", 300.0, 40.0)])
    assert readers.engine_shortfall_pct(readers.Context(native, 1, [p], Window(), None)) == 100.0
    assert readers.ENGINE_SHORTFALL_LIMIT == 50.0


def test_breakdown_gaps_are_labelled_by_the_host_op_under_way():
    t = Trace(EVENTS)
    gaps = dict(t.idle_gaps())
    # [100, 200] and [270, 300] under aten::matmul (copy_ starts after the
    # first gap's start and ends before the second's)
    assert gaps["aten::matmul"] == pytest.approx(130e-6)
    # [700, 750] and [800, 1010]: the synchronise is the innermost op under
    # way; at 1030 nothing but the span is
    assert gaps["cudaStreamSynchronize"] == pytest.approx(260e-6)
    assert gaps["(no host op)"] == pytest.approx(70e-6)
    ops = t.device_ops()
    assert ops[0] == ["void recombine_kernel<2, 256>(...)", pytest.approx(400e-6)]
    assert len(ops) == 5


def test_roofline_share_reads_nothing_without_its_kernels():
    t = Trace([e for e in EVENTS if "recombine" not in e["name"]])
    ctx = readers.Context(t, 1, [roofline.Product(1, 64, 64, 64, 9)], Window(), None)
    assert readers.roofline_share(ctx, "recombine_kernel", roofline.recombine_least_s) is None
    # nor where the mode fixes no number of slices
    auto = readers.Context(Trace(EVENTS), 1, [roofline.Product(1, 64, 64, 64, None)], Window(), None)
    assert readers.roofline_share(auto, "recombine_kernel", roofline.recombine_least_s) is None
    empty = Trace([e for e in EVENTS if e["cat"] not in ("kernel", "gpu_memcpy")])
    assert empty.idle_share() is None


def test_roofline_share_is_least_time_over_kernel_time():
    t = Trace(EVENTS)
    p = roofline.Product(1, 1024, 1024, 1024, 9)
    ctx = readers.Context(t, 2, [p, p], Window(), None)
    want = 100 * 2 * roofline.recombine_least_s(p) / 400e-6
    assert readers.roofline_share(ctx, "recombine_kernel", roofline.recombine_least_s) == \
        pytest.approx(want)


def test_a_trace_without_the_span_is_refused():
    with pytest.raises(ValueError):
        Trace([e for e in EVENTS if e["name"] != SPAN])


def test_a_trace_that_lost_its_device_records_is_captured_again(monkeypatch, capsys):
    from harness import tracing

    lost = Trace([e for e in EVENTS if e["cat"] not in ("kernel", "gpu_memcpy")])
    got = iter([(lost, 1), (lost, 2), (Trace(EVENTS), 3)])
    monkeypatch.setattr(tracing, "_capture_once", lambda run, cuda, lead: next(got))
    trace, out = tracing.capture(lambda: None, True)
    assert out == 3 and trace.device
    assert capsys.readouterr().err.count("capturing again") == 2
    # on the last attempt the trace is returned as it is
    got = iter([(lost, 1)] * tracing.ATTEMPTS)
    trace, out = tracing.capture(lambda: None, True)
    assert not trace.device
