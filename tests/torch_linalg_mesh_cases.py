"""The cases of tests/test_torch_linalg_mesh.py: the row-sharded solvers
(``lu_factor`` / ``cholesky`` with ``mesh=``, and ``solve`` through a
sharded factor).

Each rank of ``python -m ozimmu_tpu_torch.parallel.local`` runs the table
on its mesh (torch and numpy only: the rank processes never import JAX).
A case is described once, its matrix made from a seed with numpy; the
test holds rank 0's results against ``ozimmu_tpu.linalg`` and the port's
one-device factorization, and every rank's against rank 0's.
"""

from __future__ import annotations

import numpy as np
import torch

from ozimmu_tpu_torch import linalg
from ozimmu_tpu_torch.parallel.gemm import mesh_device

MODE = "fp64_int8_9"


def matrix(n: int, seed: int, cx: bool = False, spd: bool = False) -> np.ndarray:
    """Uniform [-1, 1) entries (an SPD ``g g^T + n I`` with ``spd``)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, n))
    if cx:
        a = a + 1j * rng.uniform(-1, 1, (n, n))
    return a @ a.T + n * np.eye(n) if spd else a


#: name -> (what, n, block, complex, panel, seed): the reference's
#: TestShardedLU shapes (128 / 32, Cholesky 96 / 24), and n = 90 over 4
#: ranks: blocks of 23, 23, 23, 21 rows, so most panels and U12 row
#: blocks span two ranks
SPECS = {
    "lu_host": ("lu", 128, 32, False, "host", 60),
    "lu_host_90": ("lu", 90, 24, False, "host", 63),
    "lu_device": ("lu", 128, 32, False, "device", 60),
    "zlu_host": ("lu", 70, 24, True, "host", 64),
    "zlu_device": ("lu", 70, 24, True, "device", 64),
    "cholesky": ("cholesky", 96, 24, False, None, 62),
    "cholesky_90": ("cholesky", 90, 32, False, None, 65),
}


def factor(name: str, mesh=None, device="cpu", **kw):
    """The spec's factorization: with ``mesh`` row-sharded over its dim
    "x" on the mesh's device (numpy in, numpy out), else the one-device
    resident call on ``device``.  ``(lu, piv)`` for LU, ``(l, None)``."""
    what, n, block, cx, panel, seed = SPECS[name]
    a = matrix(n, seed, cx, spd=what == "cholesky")
    where = dict(mesh=mesh, mesh_axis=kw.pop("mesh_axis", "x")) if mesh is not None else dict(
        resident=True, device=device)
    if what == "cholesky":
        return linalg.cholesky(a, mode=MODE, block=block, **where, **kw), None
    return linalg.lu_factor(a, mode=MODE, block=block, panel=panel, **where, **kw)


def _spec_case(name):
    def case(mesh):
        lu, piv = factor(name, mesh)
        return {"lu": lu} if piv is None else {"lu": lu, "piv": piv}
    return case


def case_solve(mesh):
    """A solve through a sharded factor (the reference's
    ``test_solve_through_sharded_factor``): ``lu_solve`` and ``solve``
    with ``factor=`` and a refinement step."""
    rng = np.random.default_rng(61)
    a = rng.uniform(-1, 1, size=(96, 96)) + 96 * np.eye(96)
    x_true = rng.standard_normal(96)
    b = a @ x_true
    fac = linalg.lu_factor(a, mode=MODE, block=24, mesh=mesh)
    return {"x": linalg.lu_solve(fac, b), "x_true": x_true,
            "x_solve": linalg.solve(a, b, factor=fac, refine=1)}


def case_tensor_in(mesh):
    """A tensor in comes back as a tensor where it lay; the caller's
    tensor is left as it was; the bits are the numpy call's."""
    a_np = matrix(96, 66)
    a = torch.from_numpy(a_np.copy()).to(mesh_device(mesh))
    lu, piv = linalg.lu_factor(a, mode=MODE, block=32, mesh=mesh)
    l = linalg.cholesky(torch.from_numpy(matrix(96, 67, spd=True)).to(mesh_device(mesh)),
                        mode=MODE, block=32, mesh=mesh)
    return {"is_tensor": isinstance(lu, torch.Tensor) and isinstance(l, torch.Tensor),
            "device": str(lu.device), "untouched": bool(np.array_equal(a.cpu().numpy(), a_np)),
            "lu": lu, "piv": piv, "l": l}


def _raised(fn) -> str:
    try:
        fn()
    except np.linalg.LinAlgError as e:
        return str(e)
    return ""


def case_failures(mesh):
    """A zero pivot and a block that is not positive definite raise
    ``LinAlgError`` on every rank, with either kind of panel.  Both sit at
    column 64 of 96, in the rows of rank 2, after the steps before them."""
    late = np.zeros((96, 96))
    late[:64, :64] = matrix(64, 9)
    eye = np.eye(96)
    eye[70, 70] = -1.0
    return {"host": _raised(lambda: linalg.lu_factor(late, mode=MODE, block=16, mesh=mesh)),
            "device": _raised(lambda: linalg.lu_factor(late, mode=MODE, block=16, mesh=mesh,
                                                       panel="device")),
            "not_pd": _raised(lambda: linalg.cholesky(eye, mode=MODE, block=16, mesh=mesh))}


def case_submesh(mesh):
    """Over dim "y" of a 2 x 2 mesh of the same ranks: two groups of two
    ranks, each factoring the whole matrix on its own."""
    from torch.distributed.device_mesh import init_device_mesh

    sub = init_device_mesh(mesh.device_type, (2, 2), mesh_dim_names=("x", "y"))
    lu, piv = factor("lu_host_90", sub, mesh_axis="y")
    l, _ = factor("cholesky_90", sub, mesh_axis="y")
    return {"lu": lu, "piv": piv, "l": l}


def case_budget(mesh):
    """Each rank's memory budget is its share of the device that the four
    ranks of this mesh share, while a sharded factorization runs."""
    from ozimmu_tpu_torch import schedule
    from ozimmu_tpu_torch.parallel.gemm import ranks_sharing_device

    dev = mesh_device(mesh)
    inside = []
    real = linalg.gemm_int8

    def engine(*args, **kw):
        inside.append(schedule.hbm_budget_bytes(dev))
        return real(*args, **kw)

    linalg.gemm_int8 = engine
    try:  # every rank runs a GEMM in LU: the root of step 0 its U12
        factor("lu_host_90", mesh)
        factor("cholesky_90", mesh)
    finally:
        linalg.gemm_int8 = real
    return {"count": ranks_sharing_device(mesh), "whole": schedule.hbm_budget_bytes(dev),
            "inside": np.array(inside)}


def case_profile(mesh):
    prof_lu, prof_chol = {}, {}
    factor("lu_host_90", mesh, profile=prof_lu)
    factor("cholesky_90", mesh, profile=prof_chol)
    return {"lu_keys": " ".join(sorted(prof_lu)), "chol_keys": " ".join(sorted(prof_chol)),
            "nonneg": all(v >= 0 for v in (*prof_lu.values(), *prof_chol.values()))}


CASES = {name: _spec_case(name) for name in SPECS}
CASES.update(solve=case_solve, tensor_in=case_tensor_in, failures=case_failures,
             submesh=case_submesh, budget=case_budget, profile=case_profile)


def _card_case(name):
    """On the card: the spec's sharded factor beside the one-device call on
    the card, its pivots, bits and largest relative difference."""
    def case(mesh):
        lu, piv = factor(name, mesh)
        want, want_piv = factor(name, device="cuda")
        return {"same_piv": piv is None or bool(np.array_equal(piv, want_piv)),
                "same_bits": bool(np.array_equal(np.ascontiguousarray(lu).view(np.uint64),
                                                 np.ascontiguousarray(want).view(np.uint64))),
                "rel": float(np.abs(lu - want).max() / np.abs(want).max())}
    return case


CASES_CARD = {name: _card_case(name) for name in SPECS}
