"""The row-sharded solvers (``ozimmu_tpu_torch.linalg`` with ``mesh=``) on
four gloo ranks on the CPU, against ``ozimmu_tpu.linalg`` and the port's
one-device resident factorization.

The counterparts of tests/test_linalg.py's ``TestShardedLU``: one launch
of ``ozimmu_tpu_torch.parallel.local`` runs the table of
tests/torch_linalg_mesh_cases.py on a 4 x 1 mesh (the rows sharded over
dim "x"), and each case is a test of its own.  Tolerances: with host
panels, and for Cholesky, **bitwise** (factor and pivots) against both
the port's one-device run and the JAX package's resident run on its own
default CPU device, real and complex; with device panels the same pivots
and 1e-13 relative against both (the reference's bound: its sharded
device panels are not bitwise; against the port's one-device run they
are, on the CPU, and the test says so); a solve through a sharded factor
to 1e-12.  Every rank returns the same factor.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu import linalg as jl  # noqa: E402
from ozimmu_tpu_torch import linalg as tl  # noqa: E402
from ozimmu_tpu_torch.parallel import local  # noqa: E402

import torch_linalg_mesh_cases as cases  # noqa: E402

CASES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_linalg_mesh_cases.py")
#: seconds the launch (four ranks, the whole table) may take
LAUNCH_TIMEOUT = 600


@pytest.fixture(scope="module")
def ranks():
    return local.run(f"{CASES_FILE}:CASES", "4x1", nproc=4, device="cpu", timeout=LAUNCH_TIMEOUT)


def _u64(x):
    return np.ascontiguousarray(x).view(np.uint64)


def _case(ranks, name):
    """Rank 0's results of a case; no rank failed it, and every rank holds
    the same factor."""
    errors = [str(r[f"{name}/error"]) for r in ranks if f"{name}/error" in r]
    assert not errors, errors[0]
    out = {k.split("/", 1)[1]: v for k, v in ranks[0].items() if k.startswith(name + "/")}
    for r in ranks[1:]:
        for key in ("lu", "piv", "l", "x"):
            if key in out:
                np.testing.assert_array_equal(_u64(r[f"{name}/{key}"]), _u64(out[key]))
    return out


def _pa_lu_residual(a, lu, piv):
    n = a.shape[0]
    pa = a.copy()
    for i in range(n):
        pa[[i, piv[i]], :] = pa[[piv[i], i], :]
    l = np.tril(lu, -1) + np.eye(n, dtype=lu.dtype)
    return np.linalg.norm(pa - l @ np.triu(lu)) / np.linalg.norm(a)


def _spec(name):
    what, n, block, cx, panel, seed = cases.SPECS[name]
    return cases.matrix(n, seed, cx, spd=what == "cholesky"), block, panel


@pytest.mark.parametrize("name", ["lu_host", "lu_host_90", "zlu_host"])
def test_lu_host_panels_bitwise(ranks, name):
    got = _case(ranks, name)
    a, block, _ = _spec(name)
    lu1, piv1 = cases.factor(name)  # the port, one device
    jlu, jpiv = jl.lu_factor(a, mode=cases.MODE, block=block, device=True, panel="host")
    assert got["lu"].dtype == jlu.dtype
    for lu, piv in ((lu1, piv1), (jlu, jpiv)):
        np.testing.assert_array_equal(got["piv"], piv)
        np.testing.assert_array_equal(_u64(got["lu"]), _u64(lu))
    assert _pa_lu_residual(a, got["lu"], got["piv"]) < 1e-14


@pytest.mark.parametrize("name", ["lu_device", "zlu_device"])
def test_lu_device_panels_pivot_exact(ranks, name):
    got = _case(ranks, name)
    a, block, _ = _spec(name)
    lu1, piv1 = cases.factor(name)  # the port, one device
    jlu, jpiv = jl.lu_factor(a, mode=cases.MODE, block=block, device=True, panel="device")
    for lu, piv in ((lu1, piv1), (jlu, jpiv)):
        np.testing.assert_array_equal(got["piv"], piv)
        rel = np.abs(got["lu"] - lu).max() / np.abs(lu).max()
        assert rel < 1e-13, rel
    assert _pa_lu_residual(a, got["lu"], got["piv"]) < 1e-14
    # one rank factors each panel exactly as the one-device run does
    np.testing.assert_array_equal(_u64(got["lu"]), _u64(lu1))


@pytest.mark.parametrize("name", ["cholesky", "cholesky_90"])
def test_cholesky_bitwise(ranks, name):
    got = _case(ranks, name)["lu"]
    a, block, _ = _spec(name)
    np.testing.assert_array_equal(_u64(got), _u64(cases.factor(name)[0]))
    np.testing.assert_array_equal(
        _u64(got), _u64(jl.cholesky(a, mode=cases.MODE, block=block, device=True)))
    assert np.all(np.triu(got, 1) == 0)
    assert np.linalg.norm(a - got @ got.T) / np.linalg.norm(a) < 1e-14


def test_solve_through_sharded_factor(ranks):
    got = _case(ranks, "solve")
    for key in ("x", "x_solve"):
        x = got[key]
        assert np.linalg.norm(x - got["x_true"]) / np.linalg.norm(got["x_true"]) < 1e-12, key


def test_tensor_in_tensor_out(ranks):
    got = _case(ranks, "tensor_in")
    assert bool(got["is_tensor"]) and str(got["device"]) == "cpu" and bool(got["untouched"])
    lu, piv = tl.lu_factor(cases.matrix(96, 66), mode=cases.MODE, block=32, resident=True,
                           device="cpu")
    np.testing.assert_array_equal(got["piv"], piv)
    np.testing.assert_array_equal(_u64(got["lu"]), _u64(lu))
    l = tl.cholesky(cases.matrix(96, 67, spd=True), mode=cases.MODE, block=32, resident=True,
                    device="cpu")
    np.testing.assert_array_equal(_u64(got["l"]), _u64(l))


def test_failures_raise_on_every_rank(ranks):
    for r in ranks:
        assert "zero pivot" in str(r["failures/host"])
        assert "zero pivot" in str(r["failures/device"])
        assert "not positive definite (diagonal block at 64)" in str(r["failures/not_pd"])


def test_other_dim_of_a_2d_mesh(ranks):
    """Sharded over "y" of a 2 x 2 mesh, each pair of ranks factors the
    matrix: the same bits as one device, on all four ranks."""
    got = _case(ranks, "submesh")
    lu, piv = cases.factor("lu_host_90")
    np.testing.assert_array_equal(got["piv"], piv)
    np.testing.assert_array_equal(_u64(got["lu"]), _u64(lu))
    np.testing.assert_array_equal(_u64(got["l"]), _u64(cases.factor("cholesky_90")[0]))


def test_each_rank_budgets_its_share_of_the_device(ranks):
    for r in ranks:
        assert int(r["budget/count"]) == 4
        inside = r["budget/inside"]
        assert inside.size > 0 and np.all(inside == int(r["budget/whole"]) // 4)


def test_profile_phases_per_rank(ranks):
    for r in ranks:
        assert set(str(r["profile/lu_keys"]).split()) <= {
            "panel_pull_s", "panel_host_s", "device_update_s"}
        assert "device_update_s" in str(r["profile/lu_keys"])
        assert str(r["profile/chol_keys"]) == "device_update_s panel_host_s"
        assert bool(r["profile/nonneg"])
