"""The port's resident complex LU against the benchmark's plain complex HPL
reference (``ozbench/reference/zhpl.py``, loaded by path) on the CPU:
HPL's solve of A x = b in complex128, A and b with both parts uniform in
[-0.5, 0.5) as the ZHPL configuration makes them, factored by
``linalg.lu_factor(..., panel="device")`` and solved by
``linalg.lu_solve``.  HPL's check passes, x lies near the plain complex128
solution, the complex64 control fails by orders of magnitude.  And the
solver's step counter (``linalg.LU_STEPS``), its writeback span
(``oz.lu.writeback``) and the rows a panel's pivots move."""

import importlib
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ozimmu_tpu_torch import linalg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "ozbench", "reference")
CONFIG = os.path.join(ROOT, "ozbench", "configs", "zhpl-n24576-nb1024.json")
EPS = 2.0**-53


def _reference(name):
    """``ozbench/reference/<name>.py``, loaded by path as a module of its
    package (``zhpl`` imports its sibling ``gemm``)."""
    pkg_name = "ozbench_reference_under_test"
    if pkg_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            pkg_name, os.path.join(REFERENCE, "__init__.py"),
            submodule_search_locations=[REFERENCE])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[pkg_name] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{pkg_name}.{name}")


with open(CONFIG) as _f:
    _CFG = json.load(_f)
LIMIT = _CFG["limits"]["hpl_resid"]
MODE = _CFG["mode"]
PANEL = _CFG["panel"]
#: (N, NB, seed): NB dividing N, and a last block narrower than NB
CASES = [(256, 64, 1), (320, 128, 2), (512, 128, 3)]


def _operands(n, seed):
    """A [n, n] and b [n], complex128 with both parts uniform in [-0.5, 0.5)."""
    g = torch.Generator().manual_seed(seed)
    a = torch.rand((n, n), dtype=torch.complex128, generator=g).sub_(0.5 + 0.5j)
    b = torch.rand((n,), dtype=torch.complex128, generator=g).sub_(0.5 + 0.5j)
    return a, b


_SOLVES = {}


def _solved(n, nb, seed):
    """(a, b, x of the port, x of the plain complex128 solve), once a case."""
    key = (n, nb, seed)
    if key not in _SOLVES:
        a, b = _operands(n, seed)
        x = linalg.lu_solve(linalg.lu_factor(a, mode=MODE, block=nb, panel=PANEL), b)
        _SOLVES[key] = (a, b, x, _reference("zhpl").solve(a, b))
    return _SOLVES[key]


@pytest.mark.parametrize("n,nb,seed", CASES)
def test_the_ports_complex_solve_passes_hpls_check(n, nb, seed):
    zhpl = _reference("zhpl")
    a, b, x, x_plain = _solved(n, nb, seed)
    assert x.dtype == torch.complex128 and x.shape == (n,)
    got, plain = zhpl.scaled_residual(a, x, b), zhpl.scaled_residual(a, x_plain, b)
    assert got < LIMIT
    # the engine's products are correctly rounded, so the factorization is
    # as good as LAPACK's but for the explicit-inverse TRSM, whose extra
    # error is a small multiple of cond(L11)·eps: 10× the plain solve's
    # residual leaves room for it (0.78–1.65× measured at these sizes)
    assert got <= 10 * plain
    assert zhpl.numbers(a, x, b) == {"hpl_resid": got}


@pytest.mark.parametrize("n,nb,seed", CASES)
def test_x_lies_near_the_plain_complex128_solution(n, nb, seed):
    a, _, x, x_plain = _solved(n, nb, seed)
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    # both solves are backward stable, so their forward errors are within
    # cond(A)·N·eps of the true solution (0.002–0.005 of that measured);
    # the complex64 control misses it by a factor of about 1e6
    bound = float(torch.linalg.cond(a)) * n * EPS
    assert rel <= bound


@pytest.mark.parametrize("n,nb,seed", CASES)
def test_the_complex64_control_fails_by_two_orders(n, nb, seed):
    zhpl = _reference("zhpl")
    a, b, _, x_plain = _solved(n, nb, seed)
    x = zhpl.control(a, b)
    assert x.dtype == torch.complex128
    assert zhpl.scaled_residual(a, x, b) >= 100 * LIMIT
    assert float((x - x_plain).abs().max() / x_plain.abs().max()) > \
        float(torch.linalg.cond(a)) * n * EPS


def test_a_solution_moved_in_one_entry_fails():
    zhpl = _reference("zhpl")
    a, b, x, _ = _solved(*CASES[0])
    moved = x.clone()
    j = int(moved.abs().argmax())
    moved[j] *= 1 + 2.0**-20
    assert zhpl.scaled_residual(a, moved, b) > LIMIT


@pytest.mark.parametrize("seed", [4, 5])
def test_zero_imaginary_parts_read_as_the_real_check_does(seed):
    zhpl, hpl = _reference("zhpl"), _reference("hpl")
    g = torch.Generator().manual_seed(seed)
    n = 200
    a = torch.rand((n, n), dtype=torch.float64, generator=g) - 0.5
    b = torch.rand((n,), dtype=torch.float64, generator=g) - 0.5
    x = torch.linalg.solve(a, b)

    def z(t):
        return torch.complex(t, torch.zeros_like(t))

    assert zhpl.scaled_residual(z(a), z(x), z(b)) == hpl.scaled_residual(a, x, b)


def test_the_residual_is_hpls_formula_with_complex_moduli():
    zhpl = _reference("zhpl")
    a, b = _operands(96, 6)
    # x off by ~1e-8 in every entry, so that A x - b stands far above the
    # rounding of its evaluation, whatever order the sums take
    x = zhpl.solve(a, b) * (1 + 1e-8 * _operands(96, 10)[1])
    want = (float((a @ x - b).abs().max())
            / (EPS * (float(a.abs().sum(1).max()) * float(x.abs().max())
                      + float(b.abs().max())) * 96))
    assert zhpl.scaled_residual(a, x, b) == pytest.approx(want, rel=1e-6)
    assert zhpl.BLOCK_ROWS < 2 * 24576  # the cell's A is read in row blocks


@pytest.mark.parametrize("n,nb,dtype,panel", [
    (320, 128, torch.complex128, "device"),
    (256, 64, torch.complex128, "host"),
    (192, 64, torch.float64, "device"),
    (160, 48, torch.float64, "host"),
])
def test_lu_steps_counts_each_step_by_dtype_and_panel(n, nb, dtype, panel):
    a = _operands(n, 7)[0]
    a = a if dtype == torch.complex128 else a.real.contiguous()
    before = dict(linalg.LU_STEPS)
    linalg.lu_factor(a, mode=MODE, block=nb, panel=panel)
    key = (str(dtype).removeprefix("torch."), panel)
    grown = {k: v - before.get(k, 0) for k, v in linalg.LU_STEPS.items()
             if v != before.get(k, 0)}
    assert grown == {key: math.ceil(n / nb)}


def test_the_host_path_counts_no_resident_step():
    a = _operands(128, 8)[0].numpy()
    before = dict(linalg.LU_STEPS)
    linalg.lu_factor(a, mode=MODE, block=64, device="cpu")
    assert dict(linalg.LU_STEPS) == before


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float64])
def test_the_writeback_span_opens_once_a_step_inside_its_update(dtype, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    n, nb = 160, 64
    a = _operands(n, 9)[0]
    a = a if dtype == torch.complex128 else a.real.contiguous()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        linalg.lu_factor(a, mode=MODE, block=nb, panel=PANEL)
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    sp = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
          if e.get("name", "").startswith("oz.") and "dur" in e]
    steps = math.ceil(n / nb)
    writebacks = [s for s in sp if s[2] == "oz.lu.writeback"]
    updates = [s for s in sp if s[2] == "oz.lu.update"]
    engines = [s for s in sp if s[2] == "oz.engine"]
    assert len(writebacks) == len(updates) == steps
    for w, u in zip(sorted(writebacks), sorted(updates)):
        assert u[0] <= w[0] and w[1] <= u[1]
    # the copies come after the step's engine products, none inside one
    assert not any(e[0] <= w[0] < e[1] for w in writebacks for e in engines)


def _moves_by_replay(j, n, p_loc):
    """The rows that a panel's sequential swaps move, by swapping the
    entries of an index array of every row, one pivot after the other."""
    perm = np.arange(n)
    for i, p in enumerate(p_loc):
        perm[[j + i, j + p]] = perm[[j + p, j + i]]
    moved = np.flatnonzero(perm != np.arange(n))
    return moved, perm[moved]


@pytest.mark.parametrize("n,j,jb,reach", [
    (24576, 0, 1024, None),      # ZHPL's first panel, pivots anywhere below
    (24576, 23552, 1024, None),  # its last panel, square
    (4096, 1024, 1024, 3),       # pivots near the diagonal: chains of swaps
    (300, 256, 44, None),        # a last panel narrower than the block
    (64, 0, 64, 1),              # no row moves
])
def test_panel_moves_are_the_sequential_swaps(n, j, jb, reach):
    rng = np.random.default_rng(n + j + jb)
    rows = n - j
    p_loc = np.array([i + int(rng.integers(0, min(rows - i, reach or rows - i)))
                      for i in range(jb)])
    piv = np.arange(n)
    dst, src = linalg._panel_moves(j, p_loc, piv)
    want_dst, want_src = _moves_by_replay(j, n, p_loc)
    assert np.array_equal(dst, want_dst) and np.array_equal(src, want_src)
    assert np.array_equal(piv[j:j + jb], j + p_loc)
    untouched = np.r_[0:j, j + jb:n]
    assert np.array_equal(piv[untouched], untouched)
    if reach == 1:
        assert dst.size == src.size == 0
