"""Every surface's int8 product runs through the engine's one loop
(``core.gemm._loop``) with the same steps: the calls of the plain exponent
max, split, recombination and finisher (the CPU stand-ins of the kernels'
launches) and the complex layout's copies (``core.gemm.ZLAYOUT_COPIES``)
per call, for each entry point.  CPU tensors, small shapes."""

import pytest

torch = pytest.importorskip("torch")

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch import linalg, traced  # noqa: E402
from ozimmu_tpu_torch.core import api  # noqa: E402
from ozimmu_tpu_torch.core import gemm as engine  # noqa: E402
from ozimmu_tpu_torch.ops import recombine as rec  # noqa: E402
from ozimmu_tpu_torch.ops import split  # noqa: E402

M, K, N = 12, 20, 10
MODE = "fp64_int8_9"
PHASES = ("split_A", "split_B", "int8tc+accumulate_in_f64", "copy_result")

#: (exponent, split, recombine, epilogue, zfold, layout copies) of a call
REAL = (2, 2, 1, 1, 0, 0)
COMPLEX = (4, 4, 4, 0, 1, 7)


def _mk(*shape, cx=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, dtype=torch.float64, generator=g) - 0.5
    if cx:
        x = torch.complex(x, torch.rand(shape, dtype=torch.float64, generator=g) - 0.5)
    return x


def _gemm(cx: bool, profiled: bool):
    h = ozt.create(device="cpu")
    if profiled:
        h.profiler.enable()
    a, b, c = _mk(M, K, cx=cx, seed=1), _mk(K, N, cx=cx, seed=2), _mk(M, N, cx=cx, seed=3)
    return lambda: api.gemm(a, b, mode=MODE, alpha=0.5, beta=2.0, c=c, handle=h), h


def _batched(cx: bool):
    a, b, c = _mk(3, M, K, cx=cx, seed=4), _mk(3, K, N, cx=cx, seed=5), _mk(3, M, N, cx=cx, seed=6)
    return lambda: api.gemm_batched(a, b, mode=MODE, beta=-1.0, c=c,
                                    handle=ozt.create(device="cpu")), None


def _traced(cx: bool):
    a, b, c = _mk(M, K, cx=cx, seed=7), _mk(K, N, cx=cx, seed=8), _mk(M, N, cx=cx, seed=9)
    return lambda: traced.gemm(a, b, num_split=9, alpha=1.5, beta=0.5, c=c), None


def _chunked():
    a, b = _mk(M, K, seed=10), _mk(K, N, seed=11)
    return lambda: engine.gemm_f64(a, b, 9, n_chunks=3), None


def _lu_step():
    # two blocks: one step with a trailing update, two engine products
    a = _mk(2 * 8, 2 * 8, seed=12)
    return lambda: linalg.lu_factor(a, mode=MODE, block=8), None


CASES = {
    "api.gemm real": (lambda: _gemm(False, False), REAL),
    "api.gemm real profiled": (lambda: _gemm(False, True), REAL),
    "api.gemm complex": (lambda: _gemm(True, False), COMPLEX),
    "api.gemm complex profiled": (lambda: _gemm(True, True), COMPLEX),
    "gemm_batched real": (lambda: _batched(False), REAL),
    "gemm_batched complex": (lambda: _batched(True), COMPLEX),
    "traced.gemm real": (lambda: _traced(False), REAL),
    "traced.gemm complex": (lambda: _traced(True), COMPLEX),
    # A split once, three panels of B
    "gemm_f64 n_chunks=3": (_chunked, (4, 4, 3, 3, 0, 0)),
    "lu_factor step": (_lu_step, tuple(2 * x for x in REAL)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_entry_runs_the_loops_steps_once(monkeypatch, case):
    make, want = CASES[case]
    call, handle = make()
    calls = dict.fromkeys(("exponent", "split", "recombine", "epilogue", "zfold"), 0)

    def counted(module, attr, name):
        fn = getattr(module, attr)

        def f(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, attr, f)

    counted(split, "row_exponent_plain", "exponent")
    counted(split, "split_with_row_exp", "split")
    counted(rec, "fold_group_totals", "recombine")
    counted(engine, "_epilogue_SE", "epilogue")
    counted(engine, "_zfold_passes", "zfold")
    before = engine.ZLAYOUT_COPIES
    call()
    assert (*calls.values(), engine.ZLAYOUT_COPIES - before) == want
    if handle is not None and handle.profiler.enabled:
        # one unchunked run: each phase counts once a call
        assert {row[0]: row[1] for row in handle.profiler.result_rows()} == \
            dict.fromkeys(PHASES, 1)
