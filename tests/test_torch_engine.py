"""Every surface's int8 product runs through the engine's one loop
(``core.gemm._loop``) with the same steps: the calls of the plain exponent
max, split, recombination and finisher (the CPU stand-ins of the kernels'
launches) and the complex layout's copies (``core.gemm.ZLAYOUT_COPIES``)
per call, for each entry point.  ``gemm_int8``'s ``out=``: the result in
place, bit for bit the returned tensor's, its checks and its counter
(``core.gemm.IN_PLACE``).  CPU tensors, small shapes."""

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
#: a 2-D complex ``gemm_int8``: A's and B's planes only (the fold reads c's
#: views and writes the complex128 output)
COMPLEX_INT8 = (4, 4, 4, 0, 1, 4)


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


def _lu_step(cx: bool = False):
    # two blocks: one step with a trailing update, two engine products
    a = _mk(2 * 8, 2 * 8, cx=cx, seed=12)
    return lambda: linalg.lu_factor(a, mode=MODE, block=8), None


CASES = {
    "api.gemm real": (lambda: _gemm(False, False), REAL),
    "api.gemm real profiled": (lambda: _gemm(False, True), REAL),
    "api.gemm complex": (lambda: _gemm(True, False), COMPLEX),
    "api.gemm complex profiled": (lambda: _gemm(True, True), COMPLEX),
    "gemm_batched real": (lambda: _batched(False), REAL),
    "gemm_batched complex": (lambda: _batched(True), COMPLEX),
    "traced.gemm real": (lambda: _traced(False), REAL),
    "traced.gemm complex": (lambda: _traced(True), COMPLEX_INT8),
    # A split once, three panels of B
    "gemm_f64 n_chunks=3": (_chunked, (4, 4, 3, 3, 0, 0)),
    "lu_factor step": (_lu_step, tuple(2 * x for x in REAL)),
    "lu_factor complex step": (lambda: _lu_step(True), tuple(2 * x for x in COMPLEX_INT8)),
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


def _bits(x):
    x = torch.view_as_real(x) if x.is_complex() else x
    return x.contiguous().view(torch.int64)


#: (dtype, where out lies, n_chunks, beta and c): out a window of a wider
#: matrix (row stride != n) or c itself, also a window; beta 0 with c (c
#: unread) and without
OUT_CASES = [(dt, where, chunks, beta_c)
             for dt in ("float64", "complex128") for where in ("window", "c")
             for chunks in (1, 3) for beta_c in ("beta", "beta 0, c", "beta 0, no c")
             if not (where == "c" and beta_c == "beta 0, no c")]


@pytest.mark.parametrize("dt,where,chunks,beta_c", OUT_CASES)
def test_out_holds_the_returned_tensors_bits(dt, where, chunks, beta_c):
    """``gemm_int8(..., out=)`` writes the bits the returned-tensor path
    returns (for complex128, also those of the plane path, ``zgemm_f64``
    and ``torch.complex``), into its window only, and returns ``out``."""
    cx = dt == "complex128"
    a, b = _mk(M, K, cx=cx, seed=20), _mk(K, N, cx=cx, seed=21)
    wide = _mk(M + 3, N + 5, cx=cx, seed=22)
    c = None if beta_c == "beta 0, no c" else wide[2:2 + M, 1:1 + N]
    alpha, beta = (0.5 - 0.25j, 1.5 + 0.5j) if cx else (0.5, -1.5)
    beta = 0.0 if beta_c.startswith("beta 0") else beta
    want = engine.gemm_int8(a, b, 9, alpha, beta, None if c is None else c.clone(), chunks)
    if cx:
        planes = [p for x in (a, b) for p in (x.real.contiguous(), x.imag.contiguous())]
        cp = (None, None) if c is None else (c.real.contiguous(), c.imag.contiguous())
        re, im = engine.zgemm_f64(*planes, 9, alpha, beta, *cp, n_chunks=chunks)
        assert torch.equal(_bits(want), _bits(torch.complex(re, im)))
    else:
        assert torch.equal(_bits(want), _bits(engine.gemm_f64(a, b, 9, alpha, beta, c, chunks)))
    before = wide.clone()
    if where == "c":
        out = c
    else:
        host = torch.full((M + 4, N + 7), 7.0, dtype=want.dtype)
        out = host[1:1 + M, 2:2 + N]
    assert out.stride(0) != N
    got = engine.gemm_int8(a, b, 9, alpha, beta, c, chunks, out=out)
    assert got is out and torch.equal(_bits(out), _bits(want))
    mask = torch.ones(before.shape, dtype=torch.bool)
    if where == "c":
        mask[2:2 + M, 1:1 + N] = False
        assert torch.equal(_bits(wide[mask]), _bits(before[mask]))
    else:
        mask = torch.ones(host.shape, dtype=torch.bool)
        mask[1:1 + M, 2:2 + N] = False
        assert bool((host[mask] == 7.0).all())
        assert torch.equal(_bits(wide), _bits(before))


def test_out_of_a_product_with_k_0_holds_beta_c():
    for cx in (False, True):
        a, b, c = _mk(M, 0, cx=cx), _mk(0, N, cx=cx), _mk(M, N, cx=cx, seed=23)
        beta = 0.5 + 2j if cx else -2.0
        want = engine.gemm_int8(a, b, 9, 1.0, beta, c)
        got = engine.gemm_int8(a, b, 9, 1.0, beta, c, out=c)
        assert got is c and torch.equal(_bits(c), _bits(want))


def _bad_out(case):
    a, b, c = _mk(M, K, seed=30), _mk(K, N, seed=31), _mk(M, N, seed=32)
    out = torch.empty((M, N), dtype=torch.float64)
    kw = {}
    if case == "dtype":
        out = out.to(torch.complex128)
    elif case == "shape":
        out = torch.empty((M, N + 1), dtype=torch.float64)
    elif case == "rows not contiguous":
        out = torch.empty((N, M), dtype=torch.float64).T
    elif case == "batched":
        a, b = _mk(2, M, K), _mk(2, K, N)
        out = torch.empty((2, M, N), dtype=torch.float64)
    elif case == "shares a":
        a = torch.empty((M, K + N), dtype=torch.float64)[:, :K]
        out = a.as_strided((M, N), (K + N, 1), K)
    elif case == "shares b":
        host = torch.zeros((K + M, N), dtype=torch.float64)
        b, out = host[:K], host[K:]
    elif case == "overlaps c":
        host = torch.zeros((M + 1, N), dtype=torch.float64)
        c, out = host[:M], host[1:]
        kw = dict(beta=1.0)
    return a, b, c, out, kw


@pytest.mark.parametrize("case,match", [
    ("dtype", "must be torch.float64"), ("shape", "must have shape"),
    ("rows not contiguous", "rows of out"), ("batched", "2-D products only"),
    ("shares a", "storage with a"), ("shares b", "storage with b"),
    ("overlaps c", "without being c itself"),
])
def test_a_bad_out_raises_naming_the_fault(case, match):
    a, b, c, out, kw = _bad_out(case)
    with pytest.raises(ValueError, match=match):
        engine.gemm_int8(a, b, 9, c=c, out=out, **kw)


@pytest.mark.parametrize("kind,cx", [("lu", False), ("lu", True), ("cholesky", False)])
def test_a_factorization_counts_its_in_place_updates_and_layout_copies(kind, cx):
    """One in-place product a step with a trailing block, n / NB - 1 a
    factorization; a complex step makes 8 layout copies (A's and B's
    planes of its two products), a real one none."""
    n, nb = 4 * 8, 8
    a = _mk(n, n, cx=cx, seed=40)
    before, copies = engine.IN_PLACE.copy(), engine.ZLAYOUT_COPIES
    if kind == "lu":
        linalg.lu_factor(a, mode=MODE, block=nb)
    else:
        linalg.cholesky(a @ a.T + n * torch.eye(n, dtype=a.dtype), mode=MODE, block=nb)
    dtype = "complex128" if cx else "float64"
    assert dict(engine.IN_PLACE - before) == {dtype: n // nb - 1}
    assert engine.ZLAYOUT_COPIES - copies == (8 * (n // nb - 1) if cx else 0)
