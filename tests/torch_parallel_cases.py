"""The cases of tests/test_torch_parallel.py.

Each rank of ``python -m ozimmu_tpu_torch.parallel.local`` runs one of the
tables below on its mesh (torch and numpy only: the rank processes never
import JAX).  A case is described once: the same spec, with operands made
from a seed with numpy, goes through the port here and through
``ozimmu_tpu.parallel`` and the one-device ``gemm`` in the test.

Every operand keeps the f32 intermediates of the epilogue and of the
complex fold in the normal range (XLA:CPU flushes f32 subnormals and
torch does not; that deviation is asserted in tests/test_torch_gemm.py
and tests/test_torch_complex.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

import ozimmu_tpu_torch as ozt
from ozimmu_tpu_torch import parallel as par
from ozimmu_tpu_torch.testing import generate_input

#: the budget (MB) under which the pre-sharded chooser must re-check:
#: 256 x 4096 @ 4096 x 256 at ns = 9 on a 1 x 4 mesh takes "k" (6.0 MB),
#: which pre-sharded operands cannot use; summa needs 16.4 MB, stream 15.3
RECHECK_BUDGET_MB = 15
RECHECK_SHAPE = (256, 4096, 256)


def spec(entry, m, k, n, ns=9, dist="normal01", seed=0, cx=False, c=False, local="bits", **kw):
    """A case through a host wrapper: ``entry`` is "gemm"
    (``sharded_gemm``), "k" (``sharded_gemm_k``) or "auto"
    (``sharded_gemm_auto``); ``local`` says how the result compares with
    the one-device ``gemm``: "bits", a relative tolerance, or None."""
    return dict(entry=entry, m=m, k=k, n=n, ns=ns, dist=dist, seed=seed, cx=cx, c=c,
                local=local, kw=kw)


def _mk(rng, shape, lo, hi, cx):
    """Uniform mantissas times powers of two in [lo, hi)."""
    def one():
        return rng.random(shape) * np.exp2(rng.integers(lo, hi, shape).astype(float))
    return one() + 1j * one() if cx else one()


def operands(s):
    """(a, b, c) of a spec, as stored (op T / C read them transposed)."""
    kw = s["kw"]
    ta = (s["k"], s["m"]) if kw.get("op_a", "N") != "N" else (s["m"], s["k"])
    tb = (s["n"], s["k"]) if kw.get("op_b", "N") != "N" else (s["k"], s["n"])
    tc = (s["m"], s["n"])
    if s["dist"].startswith("mk"):
        _, lo, hi = s["dist"].split(":")
        rng = np.random.default_rng(s["seed"])
        a, b = _mk(rng, ta, int(lo), int(hi), s["cx"]), _mk(rng, tb, int(lo), int(hi), s["cx"])
        c = _mk(rng, tc, -5, 5, s["cx"]) if s["c"] else None
        return a, b, c
    a = generate_input(s["dist"], ta, seed=s["seed"], complex_=s["cx"])
    b = generate_input(s["dist"], tb, seed=s["seed"] + 1, complex_=s["cx"])
    c = generate_input("normal01", tc, seed=s["seed"] + 2, complex_=s["cx"]) if s["c"] else None
    return a, b, c


def wrapper_kwargs(s):
    a, b, c = operands(s)
    kw = dict(s["kw"])
    if c is not None:
        kw["c"] = c
    return a, b, kw


def run_port(s, mesh):
    a, b, kw = wrapper_kwargs(s)
    fn = {"gemm": par.sharded_gemm, "k": par.sharded_gemm_k, "auto": par.sharded_gemm_auto}
    return fn[s["entry"]](a, b, s["ns"], mesh, **kw)


def run_local(s):
    """The port's one-device gemm on the same operands, on the CPU."""
    a, b, kw = wrapper_kwargs(s)
    kw = {k: v for k, v in kw.items() if k not in ("variant", "ring")}
    mode = "fp64_int8_auto" if s["ns"] == "auto" else f"fp64_int8_{s['ns']}"
    return ozt.gemm(a, b, mode=mode, device="cpu", **kw)


# -- cases with their own code --------------------------------------------

def selection_operands(seed, lo, hi, cx=False):
    rng = np.random.default_rng(seed)
    return _mk(rng, (32, 64), lo, hi, cx), _mk(rng, (64, 32), lo, hi, cx)


SELECTION_RANGES = ((0, 1), (-10, 10), (-150, 150))


def case_auto_selection(mesh):
    out = {}
    for i, (lo, hi) in enumerate(SELECTION_RANGES):
        a, b = selection_operands(70 + i, lo, hi)
        out[f"mode{i}"] = par.sharded_auto_mode_select(a, b, mesh).value
    a, b = selection_operands(72, -10, 10, cx=True)
    out["zmode"] = par.sharded_auto_mode_select(a, b, mesh).value
    for name in ("dgemm_fallback", "zdgemm_fallback", "auto_padded"):
        a, b, _ = operands(SPECS_2x2[name])
        out[f"{name}_mode"] = par.sharded_auto_mode_select(a, b, mesh).value
    return out


def _rejects(fn):
    try:
        fn()
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def case_ring_rejects(mesh):
    real = _rejects(lambda: par.sharded_gemm_ring_fn(mesh, 9, 128))
    cplx = _rejects(lambda: par.sharded_zgemm_ring_fn(mesh, 9, 128))
    return {"raised": real["raised"], "zraised": cplx["raised"]}


def replicated_input():
    return generate_input("exp_rand-3", (16, 24), seed=7)


def case_replicated_roundtrip(mesh):
    x = par.replicated_f64x(replicated_input(), mesh, ("x", "y"))
    return {"out": par.allgather_f64x(x), "local_shape": np.asarray(tuple(x.to_local().shape))}


def shard_local_input():
    rng = np.random.default_rng(90)
    return rng.normal(size=(32, 64)) * np.exp2(rng.integers(-8, 8, (32, 64)).astype(np.float64))


def case_shard_local(mesh):
    full = shard_local_input()
    calls = []

    def fill(idx):
        calls.append(idx)
        return full[idx]

    x = par.shard_local_f64x((32, 64), mesh, ("x", "y"), fill)
    return {"out": par.allgather_f64x(x), "calls": len(calls)}


def presharded_inputs(seed, m, k, n, cx=False, with_c=False):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.normal(size=shape)
        return x + 1j * rng.normal(size=shape) if cx else x

    fa, fb = draw((m, k)), draw((k, n))
    return fa, fb, (draw((m, n)) if with_c else None)


def _sharded(mesh, x):
    return par.shard_local_f64x(x.shape, mesh, ("x", "y"), lambda i: x[i])


def case_presharded(mesh):
    fa, fb, _ = presharded_inputs(91, 32, 64, 32)
    out = par.sharded_gemm_presharded(_sharded(mesh, fa), _sharded(mesh, fb), 9, mesh)
    return {"out": par.allgather_f64x(out), "shape": np.asarray(tuple(out.shape))}


def case_presharded_epilogue(mesh):
    fa, fb, fc = presharded_inputs(92, 16, 32, 16, with_c=True)
    out = par.sharded_gemm_presharded(_sharded(mesh, fa), _sharded(mesh, fb), 9, mesh,
                                      alpha=1.5, beta=-0.5, c=_sharded(mesh, fc))
    return {"out": par.allgather_f64x(out)}


def case_presharded_rejects_indivisible(mesh):
    from torch.distributed.tensor import DTensor, Shard

    def odd(shape):  # k = 33 does not divide over lcm(2, 2) = 2
        local = torch.zeros(tuple(-(-s // 2) for s in shape), dtype=torch.float64)
        return DTensor.from_local(local, mesh, [Shard(0), Shard(1)], run_check=False,
                                  shape=torch.Size(shape), stride=(shape[1], 1))

    return _rejects(lambda: par.sharded_gemm_presharded(odd((32, 33)), odd((33, 32)), 9, mesh))


def case_presharded_zgemm_conj(mesh):
    za, zb, _ = presharded_inputs(93, 16, 32, 16, cx=True)
    re, im = par.sharded_zgemm_presharded(
        _sharded(mesh, za.real.copy()), _sharded(mesh, za.imag.copy()),
        _sharded(mesh, zb.real.copy()), _sharded(mesh, zb.imag.copy()), 9, mesh, conj_b=True)
    return {"re": par.allgather_f64x(re), "im": par.allgather_f64x(im)}


def case_presharded_rechecks_budget(mesh):
    from ozimmu_tpu_torch.parallel.gemm import _presharded_variant

    m, k, n = RECHECK_SHAPE
    fa, fb, _ = presharded_inputs(94, m, k, n)
    saved = os.environ.get("OZIMMU_HBM_BUDGET_MB")
    os.environ["OZIMMU_HBM_BUDGET_MB"] = str(RECHECK_BUDGET_MB)
    try:
        chosen = par.select_variant(m, n, k, 9, mesh)
        variant = _presharded_variant(m, n, k, 9, mesh, "x", "y", False)
        out = par.sharded_gemm_presharded(_sharded(mesh, fa), _sharded(mesh, fb), 9, mesh)
    finally:
        if saved is None:
            del os.environ["OZIMMU_HBM_BUDGET_MB"]
        else:
            os.environ["OZIMMU_HBM_BUDGET_MB"] = saved
    return {"out": par.allgather_f64x(out), "select_variant": chosen, "variant": variant}


def case_budget_share(mesh):
    """The four ranks share the host's memory: every entry plans with a
    quarter of the budget (the budget that ``sharded_gemm_auto`` and the
    pre-sharded chooser read, and the share in force while the local
    engine runs), and the whole budget is back after each call."""
    from ozimmu_tpu_torch import schedule
    from ozimmu_tpu_torch.parallel import gemm as pg

    dev = pg.mesh_device(mesh)
    read, sharers = [], []
    real_budget, real_2d = pg.hbm_budget_bytes, pg._sharded_2d

    def budget(device=None):
        read.append(real_budget(device))
        return read[-1]

    def run_2d(*args):
        sharers.append(schedule._SHARERS)
        return real_2d(*args)

    pg.hbm_budget_bytes, pg._sharded_2d = budget, run_2d
    try:
        fa, fb, _ = presharded_inputs(95, 16, 32, 16)
        par.sharded_gemm(fa, fb, 9, mesh)
        par.sharded_gemm_auto(fa, fb, 9, mesh)
        par.sharded_gemm_presharded(_sharded(mesh, fa), _sharded(mesh, fb), 9, mesh)
    finally:
        pg.hbm_budget_bytes, pg._sharded_2d = real_budget, real_2d
    return {"count": pg.ranks_sharing_device(mesh), "whole": schedule.hbm_budget_bytes(dev),
            "read": np.array(read), "sharers": np.array(sharers)}


def _from_spec(s):
    return lambda mesh: {"out": run_port(s, mesh)}


SPECS_2x2 = {
    "summa_bitwise": spec("gemm", 32, 64, 32, seed=2),
    "summa_exp_spread": spec("gemm", 64, 64, 64, ns=14, dist="exp_rand-3", seed=4),
    "summa_uneven_logical": spec("gemm", 16, 80, 24, ns=8, dist="urand01", seed=6),
    "summa_large_k_chunk_caps": spec("gemm", 16, 2048, 16, ns=12, seed=34),
    "summa_alpha_beta": spec("gemm", 32, 64, 32, seed=20, c=True, alpha=2.5, beta=-0.75),
    "ring_alpha_beta": spec("gemm", 32, 64, 32, seed=23, c=True, alpha=0.5, beta=3.0,
                            variant="ring"),
    "summa_padded": spec("gemm", 51, 71, 29, dist="urand01", seed=29),
    "summa_padded_epilogue": spec("gemm", 51, 71, 29, seed=31, c=True, alpha=2.0, beta=1.0),
    "zsumma_bitwise": spec("gemm", 32, 64, 32, seed=50, cx=True),
    "zsumma_alpha_beta": spec("gemm", 32, 64, 32, ns=10, seed=52, cx=True, c=True,
                              alpha=1.5 - 0.5j, beta=0.25 + 2.0j),
    "zsumma_padded": spec("gemm", 35, 53, 27, dist="urand01", seed=57, cx=True),
    "zsumma_conj_transpose": spec("gemm", 32, 64, 32, seed=59, cx=True, op_a="C", op_b="C"),
    "ring_bitwise": spec("gemm", 32, 64, 32, seed=12, ring=True),
    "ring_exp_spread": spec("gemm", 64, 128, 64, ns=12, dist="exp_rand-3", seed=14, ring=True),
    "ring_rectangular_operands": spec("gemm", 64, 256, 96, dist="urand01", seed=16, ring=True),
    "zring_bitwise": spec("gemm", 32, 64, 32, seed=18, cx=True, variant="ring"),
    "zring_alpha_beta": spec("gemm", 32, 64, 32, seed=20, cx=True, c=True, alpha=1.5 - 0.5j,
                             beta=-2.0 + 0.25j, variant="ring"),
    "stream_square_mesh": spec("gemm", 32, 64, 32, seed=100, variant="stream"),
    "auto_dispatch": spec("auto", 48, 640, 32, dist="urand01", seed=60),
    "auto_dispatch_tall_k": spec("auto", 16, 4096, 16, ns=10, dist="urand01", seed=62),
    "zauto_dispatch_tall_k": spec("auto", 16, 4096, 16, ns=10, seed=82, cx=True),
    "auto_gemm_int8": spec("auto", 32, 64, 32, ns="auto", dist="mk:-10:10", seed=71),
    "zauto_gemm": spec("auto", 32, 64, 32, ns="auto", dist="mk:-8:8", seed=73, cx=True),
    "dgemm_fallback": spec("auto", 30, 50, 21, ns="auto", dist="mk:-150:150", seed=74, c=True,
                           local=None, alpha=2.5, beta=-1.5),
    "zdgemm_fallback": spec("auto", 30, 50, 21, ns="auto", dist="mk:-150:150", seed=75, cx=True,
                            c=True, local=None, alpha=1 + 2j, beta=0.5 - 1j),
    "auto_padded": spec("auto", 30, 50, 21, ns="auto", dist="mk:-4:4", seed=76, local=None),
}

SPECS_1x4 = {
    "stream_bitwise": spec("gemm", 32, 64, 32, seed=100, variant="stream"),
    "stream_epilogue": spec("gemm", 16, 32, 16, ns=10, dist="exp_rand-2", seed=102, c=True,
                            alpha=1.5, beta=-0.5, variant="stream"),
    "zstream_bitwise": spec("gemm", 16, 32, 16, seed=105, cx=True, variant="stream"),
    "summa_bitwise": spec("gemm", 32, 64, 32, seed=2),
    "summa_padded": spec("gemm", 51, 71, 29, dist="urand01", seed=29),
}

SPECS_4x1 = {
    "summa_bitwise": spec("gemm", 32, 64, 32, seed=2),
    "stream_bitwise": spec("gemm", 32, 64, 32, seed=100, variant="stream"),
    "zsumma_bitwise": spec("gemm", 32, 64, 32, seed=50, cx=True),
    "summa_padded_epilogue": spec("gemm", 51, 71, 29, seed=31, c=True, alpha=2.0, beta=1.0),
}

SPECS_K4 = {
    "k_alpha_beta": spec("k", 64, 512, 48, seed=60, c=True, alpha=2.0, beta=1.5),
    "k_padded": spec("k", 30, 250, 20, dist="urand01", seed=63),
    "k_huge_k": spec("k", 16, 4096, 16, ns=10, seed=41),
    "zk_bitwise": spec("k", 16, 512, 16, seed=80, cx=True),
    "zk_alpha_beta_padded": spec("k", 13, 250, 9, seed=81, cx=True, c=True, alpha=1.5 - 0.5j,
                                 beta=-0.25 + 2j),
}

#: mesh spec -> (specs run through a host wrapper, cases with their own code)
MESHES = {
    "2x2": (SPECS_2x2, {
        "auto_selection": case_auto_selection,
        "replicated_roundtrip": case_replicated_roundtrip,
        "shard_local": case_shard_local,
        "presharded": case_presharded,
        "presharded_epilogue": case_presharded_epilogue,
        "presharded_rejects_indivisible": case_presharded_rejects_indivisible,
        "presharded_zgemm_conj": case_presharded_zgemm_conj,
        "budget_share": case_budget_share,
    }),
    "1x4": (SPECS_1x4, {
        "ring_rejects_rectangular": case_ring_rejects,
        "presharded_rechecks_budget": case_presharded_rechecks_budget,
    }),
    "4x1": (SPECS_4x1, {"ring_rejects_rectangular": case_ring_rejects}),
    "k4": (SPECS_K4, {}),
}


def _table(mesh_spec):
    specs, custom = MESHES[mesh_spec]
    return {**{name: _from_spec(s) for name, s in specs.items()}, **custom}


CASES_2x2 = _table("2x2")
CASES_1x4 = _table("1x4")
CASES_4x1 = _table("4x1")
CASES_K4 = _table("k4")
#: the 2x2 wrapper cases alone, which run on any mesh (the card's tests)
CASES_CARD = {name: _from_spec(s) for name, s in SPECS_2x2.items()}
