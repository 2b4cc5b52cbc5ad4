"""The port's complex GEMM against the benchmark's plain complex reference
(``ozbench/reference/zgemm.py``, loaded by path) on the CPU: C = alpha·A·B
+ beta·C0 with complex alpha, beta and C0 passes both of the ZGEMM
configuration's limits; the complex64 control and each planted fault fail
at least one.  And the complex layout's span (``oz.zlayout``) and counter
(``core.gemm.ZLAYOUT_COPIES``)."""

import importlib
import importlib.util
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.core import gemm as engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "ozbench", "reference")
CONFIG = os.path.join(ROOT, "ozbench", "configs", "ozimmu-zgemm-ns9.json")
TRAFFIC = os.path.join(ROOT, "ozbench", "traffic", "zgemm-abc-8192.json")


def _reference():
    """``ozbench/reference/zgemm.py``, loaded by path as a module of its
    package (it imports its siblings ``dd`` and ``gemm``)."""
    name = "ozbench_reference_under_test"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REFERENCE, "__init__.py"), submodule_search_locations=[REFERENCE])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.zgemm")


def _json(path):
    with open(path) as f:
        return json.load(f)


LIMITS = _json(CONFIG)["limits"]
ALPHA, BETA = (complex(*_json(TRAFFIC)[k]) for k in ("alpha", "beta"))
MODE = _json(CONFIG)["mode"]
SHAPES = [(64, 48, 96), (33, 70, 129)]


def _operands(m, n, k, seed):
    g = torch.Generator().manual_seed(seed)

    def z(*shape):
        return torch.complex(torch.rand(shape, dtype=torch.float64, generator=g),
                             torch.rand(shape, dtype=torch.float64, generator=g))

    return z(m, k), z(k, n), z(m, n)


def _numbers(a, b, c0, out, seed):
    return _reference().numbers(a, b, c0, ALPHA, BETA, out, 256, seed)


def _within(nums):
    return all(nums[name] <= limit for name, limit in LIMITS.items())


def _program(a, b, c0, alpha=ALPHA, beta=BETA):
    return ozt.gemm(a, b, alpha=alpha, beta=beta, c=c0, mode=MODE, handle=ozt.create(device="cpu"))


def _no_beta(a, b, c0):
    return ozt.gemm(a, b, alpha=ALPHA, mode=MODE, handle=ozt.create(device="cpu"))


def _alpha_conjugated(a, b, c0):
    return _program(a, b, c0, alpha=ALPHA.conjugate())


def _b_conjugated(a, b, c0):
    return _program(a, b.conj().resolve_conj(), c0)


def _parts_swapped(a, b, c0):
    out = _program(a, b, c0)
    return torch.complex(out.imag, out.real)


def _im_im_dropped(a, b, c0):
    # the re·re pass less the im·im pass: dropping the latter adds it back
    return _program(a, b, c0) + ALPHA * (a.imag @ b.imag)


@pytest.mark.parametrize("m, n, k", SHAPES)
def test_the_ports_zgemm_passes_both_limits(m, n, k):
    a, b, c0 = _operands(m, n, k, seed=m + n + k)
    nums = _numbers(a, b, c0, _program(a, b, c0), seed=k)
    assert _within(nums), nums
    # far under them, as on the card
    assert all(nums[name] < limit / 50 for name, limit in LIMITS.items()), nums


@pytest.mark.parametrize("m, n, k", SHAPES)
@pytest.mark.parametrize("fault", ["control", _no_beta, _alpha_conjugated, _b_conjugated,
                                   _parts_swapped, _im_im_dropped],
                         ids=lambda f: f if isinstance(f, str) else f.__name__.strip("_"))
def test_the_control_and_each_fault_fail_a_limit(m, n, k, fault):
    a, b, c0 = _operands(m, n, k, seed=m + n + k)
    if fault == "control":
        out = _reference().control(a, b, c0, ALPHA, BETA)
    else:
        out = fault(a, b, c0)
    assert not _within(_numbers(a, b, c0, out, seed=k))


def test_the_reference_holds_an_exact_answer_to_its_rounding():
    """Entries worked out exactly (small integers) read 0."""
    g = torch.Generator().manual_seed(7)

    def ints(*shape):
        return torch.complex(*(torch.randint(-8, 9, shape, generator=g).double() for _ in "ri"))

    a, b, c0 = ints(9, 11), ints(11, 5), ints(9, 5)
    exact = ALPHA * (a @ b) + BETA * c0
    assert _numbers(a, b, c0, exact, seed=1) == {"entry_err": 0.0, "rowsum_err": 0.0}


def _calls(entry, with_c):
    a, b, c0 = _operands(12, 10, 14, seed=3)
    if entry == "gemm_batched":
        a, b, c0 = (torch.stack([x, x.flip(0)]) for x in (a, b, c0))
    kw = dict(alpha=ALPHA, beta=BETA, c=c0) if with_c else dict(alpha=ALPHA)
    return lambda: getattr(ozt, entry)(a, b, mode=MODE, handle=ozt.create(device="cpu"), **kw)


@pytest.mark.parametrize("entry", ["gemm", "gemm_batched"])
@pytest.mark.parametrize("with_c, copies", [(True, 7), (False, 5)])
def test_zlayout_copies_counts_each_plane_and_the_interleave(entry, with_c, copies):
    call = _calls(entry, with_c)
    before = engine.ZLAYOUT_COPIES
    call()
    call()
    assert engine.ZLAYOUT_COPIES - before == 2 * copies


def test_a_real_gemm_makes_no_layout_copy():
    a, b, _ = _operands(12, 10, 14, seed=4)
    before = engine.ZLAYOUT_COPIES
    ozt.gemm(a.real.contiguous(), b.real.contiguous(), mode=MODE, handle=ozt.create(device="cpu"))
    assert engine.ZLAYOUT_COPIES == before


@pytest.mark.parametrize("entry", ["gemm", "gemm_batched"])
def test_zlayout_opens_under_a_profiler_around_the_copies(entry, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    call = _calls(entry, with_c=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    events = [e for e in _json(path)["traceEvents"] if "dur" in e]

    def spans(name):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                if e.get("name") == name]

    zl, (oz_api,) = spans("oz.zlayout"), spans("oz.api")
    # the planes of a, b and c, then the result's interleave
    assert len(zl) == 4 and all(oz_api[0] <= s and e <= oz_api[1] for s, e in zl)
    engine = spans("oz.engine")
    assert engine and all(e <= engine[0][0] for _, e in zl[:3]) and zl[3][0] >= engine[-1][1]
    inside = lambda t: any(s <= t[0] and t[1] <= e for s, e in zl)  # noqa: E731
    assert all(inside(t) for t in spans("aten::complex")) and spans("aten::complex")
    assert sum(inside(t) for t in spans("aten::contiguous")) == 6
