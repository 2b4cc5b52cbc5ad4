"""The program's spans (``utils/profiling.span``): one ``oz.*`` host span
at each layer edge, nested as the layers call each other, in a
``torch.profiler`` trace; nothing built while no profiler is active.  CPU
tensors, small shapes.  The ``cuda`` test at the end puts each port
kernel's launch inside its layer's span in a device trace; run it on the
GPU machine with ``python -m pytest --noconftest tests/test_torch_spans.py -m cuda``
(the suite's conftest imports jax, which that machine need not have)."""

import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import ozimmu_tpu_torch as ozt  # noqa: E402
import ozimmu_tpu_torch.intercept as ozi  # noqa: E402
from ozimmu_tpu_torch import linalg  # noqa: E402
from ozimmu_tpu_torch.core import api  # noqa: E402
from ozimmu_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    ozi.disable()


def _operands(n=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((n, n), dtype=torch.float64, generator=g) for _ in range(2)]


def _traced_spans(fn, tmp_path):
    """``(result, spans)``: ``fn()`` under a CPU profiler, and the ``oz.*``
    spans of its Chrome trace as ``(start, end, name)``, by start (the
    longer first where two start together)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    sp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
          if e.get("name", "").startswith("oz.") and "dur" in e]
    return out, sorted(sp, key=lambda x: (x[0], x[0] - x[1]))


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _names(sp):
    return [n for _, _, n in sp]


def _check_one_gemm(sp):
    """One real GEMM's spans, in start order: the API, the engine, two
    splits, the recombination and the epilogue, each step inside the
    engine and after the one before."""
    assert _names(sp) == ["oz.api", "oz.engine", "oz.split", "oz.split", "oz.recombine",
                          "oz.epilogue"]
    api_, engine, *steps = sp
    assert _inside(engine, api_)
    assert all(_inside(s, engine) for s in steps)
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))


def test_a_gemm_opens_one_span_per_layer_nested(tmp_path):
    a, b = _operands()
    out, sp = _traced_spans(lambda: api.gemm(a, b, mode="fp64_int8_9"), tmp_path)
    _check_one_gemm(sp)
    assert torch.equal(out, api.gemm(a, b, mode="fp64_int8_9"))


def test_an_intercepted_matmul_adds_the_interceptors_span_around_them(tmp_path):
    a, b = _operands()
    h = ozt.create(device="cpu")
    h.intercept_threshold_m = h.intercept_threshold_n = h.intercept_threshold_k = 64

    def call():
        with ozi.intercept(mode="fp64_int8_9", handle=h):
            return a @ b

    out, sp = _traced_spans(call, tmp_path)
    assert _names(sp)[0] == "oz.intercept" and _names(sp).count("oz.intercept") == 1
    assert all(_inside(s, sp[0]) for s in sp[1:])
    _check_one_gemm(sp[1:])
    assert torch.equal(out, api.gemm(a, b, mode="fp64_int8_9"))


def test_a_staged_profiled_gemm_shows_the_phases_as_spans(tmp_path):
    a, b = _operands()
    h = ozt.create(device="cpu")
    h.profiler.enable()
    _, sp = _traced_spans(lambda: api.gemm(a, b, mode="fp64_int8_9", handle=h), tmp_path)
    phases = [n for n in _names(sp) if n.startswith("oz.phase.")]
    assert phases == ["oz.phase.split_A", "oz.phase.split_B",
                      "oz.phase.int8tc+accumulate_in_f64", "oz.phase.copy_result"]
    by = dict((n, (s, e)) for s, e, n in sp)
    assert _inside(by["oz.recombine"], by["oz.phase.int8tc+accumulate_in_f64"])
    assert _inside(by["oz.epilogue"], by["oz.phase.copy_result"])


@pytest.mark.parametrize("panel", ["device", "host"])
def test_a_resident_lu_opens_the_solvers_spans_once_a_panel(tmp_path, panel):
    n, block = 96, 32
    g = torch.Generator().manual_seed(3)
    a = torch.rand((n, n), dtype=torch.float64, generator=g) - 0.5
    (lu, piv), sp = _traced_spans(
        lambda: linalg.lu_factor(a, mode="fp64_int8_9", block=block, panel=panel), tmp_path)
    panels = math.ceil(n / block)
    names = _names(sp)
    assert names[0] == "oz.lu_factor" and names.count("oz.lu_factor") == 1
    assert all(_inside(s, sp[0]) for s in sp[1:])
    assert names.count("oz.lu.panel") == panels
    assert names.count("oz.lu.pivots") == (panels if panel == "device" else 0)
    # the pivots' read-back is a step of the device panel's factorization
    panel_spans = [s for s in sp if s[2] == "oz.lu.panel"]
    assert all(any(_inside(p, f) for f in panel_spans) for p in sp if p[2] == "oz.lu.pivots")
    assert names.count("oz.lu.swap") == panels
    assert names.count("oz.lu.update") == panels
    # two engine products a step with a trailing block, each inside its update
    assert names.count("oz.engine") == 2 * (panels - 1)
    updates = [s for s in sp if s[2] == "oz.lu.update"]
    assert all(any(_inside(e, u) for u in updates) for e in sp if e[2] == "oz.engine")
    rhs = torch.ones(n, dtype=torch.float64)
    x, xs = _traced_spans(lambda: linalg.lu_solve((lu, piv), rhs), tmp_path)
    assert _names(xs) == ["oz.lu_solve"] and x.shape == (n,)


def test_without_a_profiler_no_record_function_is_built(monkeypatch):
    a, b = _operands()
    m = (torch.rand((96, 96), dtype=torch.float64, generator=torch.Generator().manual_seed(5))
         - 0.5)
    want = (api.gemm(a, b, mode="fp64_int8_9"),
            linalg.lu_factor(m, mode="fp64_int8_9", block=32, panel="device"))

    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler active")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    got = (api.gemm(a, b, mode="fp64_int8_9"),
           linalg.lu_factor(m, mode="fp64_int8_9", block=32, panel="device"))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][0], want[1][0]) and (got[1][1] == want[1][1]).all()
    with profiling.span("oz.api"):
        pass


def test_a_span_is_a_record_function_range_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.span("oz.api") is profiling.span("oz.engine")
    with profile(activities=[ProfilerActivity.CPU]):
        inner = profiling.span("oz.api")
    assert isinstance(inner, torch.autograd.profiler.record_function)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: each port kernel (by name) and the span its launch belongs in
KERNEL_SPANS = (("recombine_kernel", "oz.recombine"), ("split_rows_kernel", "oz.split"),
                ("split_tiles_kernel", "oz.split"), ("exponent_rows_kernel", "oz.split"),
                ("exponent_cols_kernel", "oz.split"), ("epilogue_kernel", "oz.epilogue"))

_TRACE_ONE_CALL = """
import json, os, sys
import torch
import ozimmu_tpu_torch as ozt
import ozimmu_tpu_torch.intercept as ozi
from ozimmu_tpu_torch import native
native.lib()
g = torch.Generator(device="cuda").manual_seed(11)
a, b = (torch.rand((1024, 1024), dtype=torch.float64, device="cuda", generator=g)
        for _ in range(2))
with ozi.intercept(mode="fp64_int8_9"):
    torch.cat((a, a)) @ b  # warm at another signature: the traced call, its signature's
    torch.cuda.synchronize()  # first, runs the eager chain (a later one would replay it)
    with ozt.device_trace(sys.argv[1]):
        c = a @ b
(path,) = [os.path.join(sys.argv[1], f) for f in os.listdir(sys.argv[1])]
print(path)
"""


@pytest.mark.cuda
def test_each_kernel_launch_lies_inside_its_layers_span_on_the_card(tmp_path):
    """In a device trace of one intercepted 1024^3 call, made in a process
    of its own, each port kernel is joined to its launch by correlation id,
    and the launch lies inside the span of the kernel's layer: the spans
    and the device's operations share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    p = subprocess.run([sys.executable, "-c", _TRACE_ONE_CALL, str(tmp_path)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    with open(p.stdout.strip().splitlines()[-1]) as f:
        events = json.load(f)["traceEvents"]
    sp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
          if e.get("cat") == "user_annotation" and e.get("name", "").startswith("oz.")]
    assert sorted({n for _, _, n in sp}) == ["oz.api", "oz.engine", "oz.epilogue",
                                             "oz.intercept", "oz.recombine", "oz.split"]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    seen = set()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for pattern, layer in KERNEL_SPANS:
            if pattern in e["name"]:
                t = launches[e["args"]["correlation"]]
                assert any(s <= t <= end for s, end, n in sp if n == layer), (e["name"], layer)
                seen.add(pattern)
    assert {"recombine_kernel", "epilogue_kernel"} <= seen
    assert seen & {"split_rows_kernel", "split_tiles_kernel"}
    assert seen >= {"exponent_rows_kernel", "exponent_cols_kernel"}
