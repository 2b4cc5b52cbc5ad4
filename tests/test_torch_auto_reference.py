"""The port's AUTO mode against the benchmark's plain AUTO rule
(``ozbench/reference/auto.py``) and its GEMM reference
(``ozbench/reference/gemm.py``), both loaded by path, on the CPU: on
operands of a narrow and of wide exponent ranges (ozIMMU's ``urand01`` and
``exp_rand-φ``) AUTO chooses the rule's mode and its product passes the
AUTO configuration's limits; a mode one below the rule's, the float32
control and a flipped low mantissa bit of C each fail one.  And AUTO's
span (``oz.auto``) and counter (``core.gemm.AUTO_CHOICES``) at each of
the four AUTO sites of the public API and the interceptor's 2-D route."""

import ast
import functools
import importlib
import importlib.util
import json
import os
import sys
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.core import api  # noqa: E402
from ozimmu_tpu_torch.core import gemm as engine  # noqa: E402
from ozimmu_tpu_torch.ops.mantissa_loss import mantissa_loss_totals  # noqa: E402
from ozimmu_tpu_torch.types import ComputeMode  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "ozbench")
REFERENCE = os.path.join(BENCH, "reference")
CONFIG = os.path.join(BENCH, "configs", "ozimmu-dgemm-auto-exprand2.json")
AUTO = "fp64_int8_auto"


def _reference(name):
    """``ozbench/reference/<name>.py``, loaded by path as a module of its
    package (``gemm`` imports its sibling ``dd``)."""
    pkg_name = "ozbench_reference_under_test"
    if pkg_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            pkg_name, os.path.join(REFERENCE, "__init__.py"), submodule_search_locations=[REFERENCE])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[pkg_name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{pkg_name}.{name}")


with open(CONFIG) as _f:
    LIMITS = json.load(_f)["limits"]
GEMM_LIMITS = {name: LIMITS[name] for name in ("entry_err", "rowsum_err")}

#: operand kinds: φ of ozIMMU's exp_rand-φ, 0 for urand01
KINDS = {"urand01": 0.0, "exp_rand-2": 2.0, "exp_rand-4": 4.0}
KS = [1024, 4096]
THRESHOLDS = [0.0, 1e-4]
M, N = 40, 56


def _law(shape, g, phi):
    """urand01 (phi 0), else exp_rand-phi: (u - 0.5)·exp(phi·z)."""
    u = torch.rand(shape, dtype=torch.float64, generator=g)
    if not phi:
        return u
    z = torch.randn(shape, dtype=torch.float64, generator=g)
    return z.mul_(phi).exp_().mul_(u.sub_(0.5))


@functools.lru_cache(maxsize=None)
def _operands(kind, k):
    g = torch.Generator().manual_seed(2**31 + 29 + k)
    return _law((M, k), g, KINDS[kind]), _law((k, N), g, KINDS[kind])


def _handle(threshold):
    h = ozt.create(device="cpu")
    ozt.set_auto_mantissa_loss_threshold(h, threshold)
    return h


def _auto_call(a, b, threshold, **kw):
    """(the product in AUTO, the decisions that the call counted)."""
    before = Counter(engine.AUTO_CHOICES)
    out = ozt.gemm(a, b, mode=AUTO, handle=_handle(threshold), **kw)
    return out, Counter(engine.AUTO_CHOICES) - before


@functools.lru_cache(maxsize=None)
def _case(kind, k, threshold):
    a, b = _operands(kind, k)
    out, chosen = _auto_call(a, b, threshold)
    return a, b, out, chosen, _reference("auto").mode(a, b, threshold)


def _gemm_numbers(a, b, out):
    return _reference("gemm").numbers(a, b, out, 256, 2**31 + 3)


def _within(nums, limits):
    return all(nums[name] <= limit for name, limit in limits.items())


CASES = [(kind, k, t) for kind in KINDS for k in KS for t in THRESHOLDS]


@pytest.mark.parametrize("kind, k, threshold", CASES)
def test_the_ports_auto_chooses_the_rules_mode(kind, k, threshold):
    a, b, _, chosen, want = _case(kind, k, threshold)
    assert chosen == Counter({want: 1})
    assert ozt.auto_mode_select(a, b, threshold=threshold, handle=_handle(0.0)).value == want
    ref = _reference("auto")
    assert ref.mode_err(chosen, want) == 0.0 <= LIMITS["auto_mode_err"]
    # the rule's totals are the port's estimator's, exactly
    b_bits = ref.bits_per_slice(k)
    port = mantissa_loss_totals(a, b_bits, 1) + mantissa_loss_totals(b, b_bits, 0)
    assert ref.loss_totals(a, b) == port.tolist()


@pytest.mark.parametrize("kind, k, threshold", CASES)
def test_the_auto_product_passes_both_limits(kind, k, threshold):
    a, b, out, _, want = _case(kind, k, threshold)
    assert want.startswith("fp64_int8_")
    nums = _gemm_numbers(a, b, out)
    assert _within(nums, GEMM_LIMITS), nums


def test_the_modes_chosen_widen_with_the_exponent_range():
    """At exp_rand-2 and the configuration's threshold the rule takes ns
    12, as at 8192²; a wider range takes more slices, a narrower fewer."""
    ns = {kind: int(_case(kind, 4096, 1e-4)[4].rsplit("_", 1)[1]) for kind in KINDS}
    assert ns == {"urand01": 10, "exp_rand-2": 12, "exp_rand-4": 15}
    assert all(_case(kind, 4096, 0.0)[4] >= _case(kind, 4096, 1e-4)[4] for kind in KINDS)


def test_the_rules_slice_width_is_the_ports():
    for k in (1, 2, 3, 1024, 4096, 8192, 2**17, 2**17 + 1, 2**20, 2**31):
        assert _reference("auto").bits_per_slice(k) == ozt.bits_per_int8(k), k


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_mode_one_below_the_rules_fails_auto_mode_err(kind, monkeypatch):
    a, b, _, _, want = _case(kind, 1024, 1e-4)
    ns = int(want.rsplit("_", 1)[1])
    monkeypatch.setattr(api, "_auto_mode_select_core",
                        lambda *args, **kw: ComputeMode.from_num_split(ns - 1))
    _, chosen = _auto_call(a, b, 1e-4)
    assert chosen == Counter({f"fp64_int8_{ns - 1}": 1})
    assert _reference("auto").mode_err(chosen, want) == 1.0 > LIMITS["auto_mode_err"]


def test_a_run_without_decisions_fails_auto_mode_err():
    assert _reference("auto").mode_err(Counter(), "fp64_int8_12") == 1.0
    assert _reference("auto").mode_err(Counter({"fp64_int8_12": 3, "fp64_int8_11": 1}),
                                       "fp64_int8_12") == 0.25


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_flipped_low_mantissa_bit_of_c_fails_a_limit(kind):
    a, b, out, _, _ = _case(kind, 1024, 1e-4)
    bad = out.clone()
    flat = bad.view(-1).view(torch.int64)
    at = int(out.abs().argmax())
    flat[at] ^= 1 << 20
    assert not _within(_gemm_numbers(a, b, bad), GEMM_LIMITS)


@pytest.mark.parametrize("kind", list(KINDS))
def test_the_float32_control_fails_a_limit(kind):
    a, b = _operands(kind, 1024)
    assert not _within(_gemm_numbers(a, b, _reference("gemm").control(a, b)), GEMM_LIMITS)


def _site_call(site, mode):
    """One call of an AUTO site of the public API at CPU sizes."""
    g = torch.Generator().manual_seed(11)

    def real(*shape):
        return _law(shape, g, 2.0)

    def cplx(*shape):
        return torch.complex(real(*shape), real(*shape))

    make = cplx if site.endswith("complex") else real
    lead = (3,) if site.startswith("batched") else ()
    a, b = make(*lead, 12, 64), make(*lead, 64, 10)
    entry = ozt.gemm_batched if site.startswith("batched") else ozt.gemm
    return lambda: entry(a, b, mode=mode, handle=_handle(1e-4))


SITES = ["real", "complex", "batched real", "batched complex"]


@pytest.mark.parametrize("site", SITES)
def test_auto_choices_counts_one_decision_a_call_at_each_site(site):
    call = _site_call(site, AUTO)
    before = Counter(engine.AUTO_CHOICES)
    call()
    call()
    chosen = Counter(engine.AUTO_CHOICES) - before
    assert sum(chosen.values()) == 2 and len(chosen) == 1
    assert next(iter(chosen)).startswith("fp64_int8_")


@pytest.mark.parametrize("site", SITES)
def test_a_fixed_mode_call_counts_no_decision(site):
    before = Counter(engine.AUTO_CHOICES)
    _site_call(site, "fp64_int8_9")()
    assert Counter(engine.AUTO_CHOICES) == before


def test_a_fallback_counts_as_dgemm(monkeypatch):
    monkeypatch.delenv("OZIMMU_AUTO_FALLBACK", raising=False)
    g = torch.Generator().manual_seed(5)
    a, b = torch.rand((8, 32), dtype=torch.float64, generator=g), \
        torch.rand((32, 6), dtype=torch.float64, generator=g)
    a[:, 0] = 2.0**-1000  # 1000 binades below each row's largest element
    out, chosen = _auto_call(a, b, 0.0)
    assert chosen == Counter({"dgemm": 1})
    assert _reference("auto").mode(a, b, 0.0) == "dgemm"
    assert torch.equal(out, a @ b)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_an_intercepted_auto_matmul_counts_its_decision_inside_oz_auto(kind, tmp_path):
    import ozimmu_tpu_torch.intercept as ozi

    a, b = (_law((64, 64), torch.Generator().manual_seed(s), 2.0) for s in (1, 2))
    if kind == "complex":
        a, b = torch.complex(a, b), torch.complex(b, a)
    h = _handle(1e-4)
    for axis in "mnk":
        setattr(h, f"intercept_threshold_{axis}", 64)
    before = Counter(engine.AUTO_CHOICES)
    try:
        with ozi.intercept(mode=AUTO, handle=h):
            spans = _auto_spans(lambda: torch.matmul(a, b), tmp_path)
    finally:
        ozi.disable()
    chosen = Counter(engine.AUTO_CHOICES) - before
    assert sum(chosen.values()) == 1 and next(iter(chosen)).startswith("fp64_int8_")
    (auto,), (routed,) = spans("oz.auto"), spans("oz.intercept")
    assert routed[0] <= auto[0] and auto[1] <= routed[1]


def _auto_spans(call, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e]

    def spans(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                if e.get("name") == name]

    return spans


@pytest.mark.parametrize("site", SITES)
def test_oz_auto_opens_inside_the_api_before_the_engine(site, tmp_path):
    spans = _auto_spans(_site_call(site, AUTO), tmp_path)
    (auto,), (oz_api,) = spans("oz.auto"), spans("oz.api")
    assert oz_api[0] <= auto[0] and auto[1] <= oz_api[1]
    assert all(auto[1] <= s for s, _ in spans("oz.engine")) and spans("oz.engine")


@pytest.mark.parametrize("site", SITES)
def test_a_fixed_mode_call_opens_no_oz_auto(site, tmp_path):
    spans = _auto_spans(_site_call(site, "fp64_int8_9"), tmp_path)
    assert spans("oz.api") and not spans("oz.auto")


def test_the_operand_file_follows_the_law():
    path = os.path.join(BENCH, "operands", "exp_rand-2.py")
    spec = importlib.util.spec_from_file_location("ozbench_operand_exp_rand_2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.make((33, 17), torch.Generator().manual_seed(9), torch.device("cpu"))
    assert torch.equal(got, _law((33, 17), torch.Generator().manual_seed(9), 2.0))


def test_the_rule_imports_nothing_of_the_program():
    tree = ast.parse(open(os.path.join(REFERENCE, "auto.py")).read())
    names = {a.name.partition(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module.partition(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0}
    assert names <= {"__future__", "typing", "numpy", "torch"}
