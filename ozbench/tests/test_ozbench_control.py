"""``correct`` against what it has to catch, at sizes that a test can hold:
the program passes; the control (the plain reference in the program's
place, in float32) fails; and a run with its timed path broken underneath
fails, once for each fault that a cell can have.  Each run goes past the
harness's look for a card and drives the rest of a run."""

import types

import numpy as np
import pytest
import torch

import ozimmu_tpu_torch as ozt
from ozimmu_tpu_torch.core import api

from conftest import run_small, traced_on_the_card
from reference import gemm as ref_gemm
from reference import hpl as ref_hpl

GEMM_CELLS = ["dgemm-16384-ns9", "dgemm-b4x4096-ns9"]
ALL_CELLS = GEMM_CELLS + ["dgemm-1024-intercept", "hpl-45056-nb1024"]


def _altered(fn, where):
    """``fn`` with one entry of its answer moved by a relative 2^-20."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[where] *= 1 + 2.0**-20
        return out
    return wrapped


def _gemm_control(a, b, **_):
    return ref_gemm.control(a, b)


def _hpl_control_program():
    return types.SimpleNamespace(linalg=types.SimpleNamespace(
        lu_factor=lambda a, **_: a, lu_solve=lambda a, b: ref_hpl.control(a, b)))


def _assert_caught(r):
    assert r["correct"] is False and r["failed"] >= 1
    assert any(isinstance(c["value"], str) or c["value"] > c["limit"]
               for c in r["checks"].values())


@pytest.mark.parametrize("cell", ALL_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_program_passes(small, cell, trace):
    r = run_small(small, cell, trace=trace)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"


def _control_runs(cell, monkeypatch):
    if cell == "hpl-45056-nb1024":
        return _hpl_control_program()
    if cell == "dgemm-1024-intercept":
        monkeypatch.setattr(api, "gemm", _gemm_control)
        return None
    return types.SimpleNamespace(gemm=_gemm_control, gemm_batched=_gemm_control)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_fails(small, cell, monkeypatch):
    _assert_caught(run_small(small, cell, program=_control_runs(cell, monkeypatch)))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_fails_on_the_card(small, card, cell, monkeypatch):
    for seed in (31, 32, 33):
        _assert_caught(run_small(small, cell, seed=seed, device=card,
                                 program=_control_runs(cell, monkeypatch)))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_a_float64_fallback_is_caught_on_the_card(small, card, cell):
    r = traced_on_the_card(small, cell, seed=41, fault="fallback")
    _assert_caught(r)
    assert r["checks"]["engine_shortfall_pct"]["value"] == 100.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_program_passes_on_the_card(small, card, cell):
    r = traced_on_the_card(small, cell, seed=42)
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["engine_shortfall_pct"]["value"] == 0.0, r["checks"]


def test_a_metric_that_reads_nothing_is_named_on_stderr(small, capsys):
    r = run_small(small, "dgemm-16384-ns9", trace=True)
    # on the CPU the trace holds no kernel, so no roofline has a time to read
    assert "recombine_roofline.gemm" not in r["metrics"]
    assert "[metric] recombine_roofline.gemm read nothing" in capsys.readouterr().err


def test_an_answer_altered_in_the_2d_gemm_is_caught(small):
    prog = types.SimpleNamespace(gemm=_altered(ozt.gemm, (37, 11)))
    _assert_caught(run_small(small, "dgemm-16384-ns9", program=prog))


def test_an_answer_altered_in_a_batch_is_caught(small):
    prog = types.SimpleNamespace(gemm_batched=_altered(ozt.gemm_batched, (3, 20, 7)))
    _assert_caught(run_small(small, "dgemm-b4x4096-ns9", program=prog))


@pytest.mark.parametrize("rest", ["zeros", "first_half_again"])
def test_half_of_the_batch_left_out_is_caught(small, rest):
    def half(a, b, **kw):
        h = a.shape[0] // 2
        done = ozt.gemm_batched(a[:h], b[:h], **kw)
        tail = torch.zeros_like(done) if rest == "zeros" else done
        return torch.cat([done, tail])

    _assert_caught(run_small(small, "dgemm-b4x4096-ns9",
                             program=types.SimpleNamespace(gemm_batched=half)))


def test_an_answer_altered_behind_the_interceptor_is_caught(small, monkeypatch):
    monkeypatch.setattr(api, "gemm", _altered(api.gemm, (5, 40)))
    _assert_caught(run_small(small, "dgemm-1024-intercept"))


def test_the_interceptor_routes_the_cells_calls(small, monkeypatch):
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return ozt.gemm(*args, **kwargs)

    monkeypatch.setattr(api, "gemm", counted)
    r = run_small(small, "dgemm-1024-intercept")
    assert r["correct"] and len(calls) >= r["attempted"]


def test_a_factorization_that_leaves_a_unchanged_is_caught(small):
    def unchanged(a, **_):
        return a.clone(), np.arange(a.shape[0])

    prog = types.SimpleNamespace(linalg=types.SimpleNamespace(lu_factor=unchanged,
                                                              lu_solve=ozt.linalg.lu_solve))
    _assert_caught(run_small(small, "hpl-45056-nb1024", program=prog))


def test_a_solution_altered_is_caught(small):
    def altered(fac, b):
        x = ozt.linalg.lu_solve(fac, b).clone()
        x[3] *= 1 + 1e-3
        return x

    prog = types.SimpleNamespace(linalg=types.SimpleNamespace(lu_factor=ozt.linalg.lu_factor,
                                                              lu_solve=altered))
    _assert_caught(run_small(small, "hpl-45056-nb1024", program=prog))


def test_a_run_without_a_card_fails_and_prints_no_result():
    import subprocess
    import sys

    from conftest import ROOT

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "ozbench/run.py", "--workload", "dgemm-16384-ns9",
                        "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
