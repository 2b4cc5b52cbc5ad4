"""ozimmu_tpu_torch.parallel on four gloo ranks on the CPU, against
ozimmu_tpu.parallel on a JAX mesh of the same shape (4 of the 8 virtual
devices of tests/conftest.py) and against the port's one-device ``gemm``.

One launch of ``ozimmu_tpu_torch.parallel.local`` per mesh shape (2x2,
1x4, 4x1 and the 1-D "k" mesh of 4) runs that mesh's table of
tests/torch_parallel_cases.py; each case is a test of its own.  Every
variant, real and complex, with and without alpha / beta / c, on padded
shapes, through AUTO and the pre-sharded entries, gives the same float64
bits as the JAX package on the same mesh shape, and where the digit width
is unchanged by padding, as the one-device ``gemm``.  Every rank returns
the same global result.  The counterparts of tests/test_parallel.py's
classes, in that order, plus the budget re-check of the pre-sharded
entries that the JAX package lacks.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import ozimmu_tpu as oz  # noqa: E402
from ozimmu_tpu.parallel import gemm as jpar  # noqa: E402
from ozimmu_tpu.parallel import launch as jlaunch  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.parallel import local  # noqa: E402

import torch_parallel_cases as cases  # noqa: E402

CASES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_cases.py")
#: seconds one launch (four ranks, one mesh's table) may take
LAUNCH_TIMEOUT = 600

TABLES = {"2x2": "CASES_2x2", "1x4": "CASES_1x4", "4x1": "CASES_4x1", "k4": "CASES_K4"}
_launched = {}


def _ranks(mesh_spec):
    """Every rank's results of one mesh's table, launched once per module."""
    if mesh_spec not in _launched:
        _launched[mesh_spec] = local.run(f"{CASES_FILE}:{TABLES[mesh_spec]}", mesh_spec, nproc=4,
                                         device="cpu", timeout=LAUNCH_TIMEOUT)
    return _launched[mesh_spec]


@pytest.fixture(scope="module")
def launches():
    yield _ranks
    _launched.clear()


def _jax_mesh(mesh_spec):
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual devices")
    if mesh_spec.startswith("k"):
        return Mesh(np.array(devs[:4]), ("k",))
    xs, ys = (int(v) for v in mesh_spec.split("x"))
    return Mesh(np.array(devs[:4]).reshape(xs, ys), ("x", "y"))


def _u64(x):
    return np.ascontiguousarray(x).view(np.uint64)


def _case(launches, mesh_spec, name):
    """Rank 0's results of a case; no rank failed it, and every rank holds
    the same global result."""
    ranks = launches(mesh_spec)
    errors = [str(r[f"{name}/error"]) for r in ranks if f"{name}/error" in r]
    assert not errors, errors[0]
    out = {k.split("/", 1)[1]: v for k, v in ranks[0].items() if k.startswith(name + "/")}
    for r in ranks[1:]:
        for key in ("out", "re", "im"):
            if key in out:
                np.testing.assert_array_equal(_u64(r[f"{name}/{key}"]), _u64(out[key]))
    return out


def _run_jax(s, jmesh):
    a, b, kw = cases.wrapper_kwargs(s)
    fn = {"gemm": jpar.sharded_gemm, "k": jpar.sharded_gemm_k, "auto": jpar.sharded_gemm_auto}
    return fn[s["entry"]](a, b, s["ns"], jmesh, **kw)


#: the native-f64 fallback sums in another order than XLA's dot: held to
#: the JAX tests' tolerances against numpy, not to bits
FALLBACK_TOL = {"dgemm_fallback": 1e-14, "zdgemm_fallback": 1e-13}

WRAPPER_CASES = [(m, name) for m, (specs, _) in cases.MESHES.items() for name in specs]


@pytest.mark.parametrize("mesh_spec,name", WRAPPER_CASES,
                         ids=[f"{m}-{n}" for m, n in WRAPPER_CASES])
def test_wrapper_case(launches, mesh_spec, name):
    s = cases.MESHES[mesh_spec][0][name]
    got = _case(launches, mesh_spec, name)["out"]
    a, b, kw = cases.wrapper_kwargs(s)
    assert got.shape == (s["m"], s["n"]) and got.dtype == (np.complex128 if s["cx"] else np.float64)
    if name in FALLBACK_TOL:
        ref = kw.get("alpha", 1.0) * (a @ b) + kw.get("beta", 0.0) * kw["c"]
        for out in (got, _run_jax(s, _jax_mesh(mesh_spec))):
            rel = np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1e-280))
            assert rel < FALLBACK_TOL[name], rel
        return
    np.testing.assert_array_equal(_u64(got), _u64(_run_jax(s, _jax_mesh(mesh_spec))))
    if s["local"] == "bits":
        np.testing.assert_array_equal(_u64(got), _u64(cases.run_local(s)))
    else:
        ref = a.astype(np.longdouble) @ b.astype(np.longdouble)
        assert np.linalg.norm((got - ref).astype(np.float64)) / np.linalg.norm(
            ref.astype(np.float64)) < 1e-15


def test_auto_selection_matches_jax_and_one_device(launches):
    got = _case(launches, "2x2", "auto_selection")
    jmesh = _jax_mesh("2x2")
    for i, (lo, hi) in enumerate(cases.SELECTION_RANGES):
        a, b = cases.selection_operands(70 + i, lo, hi)
        want = jpar.sharded_auto_mode_select(a, b, jmesh)
        assert str(got[f"mode{i}"]) == want.value == ozt.auto_mode_select(a, b, device="cpu").value
        assert want == oz.auto_mode_select(a, b), (lo, hi)
    a, b = cases.selection_operands(72, -10, 10, cx=True)
    assert str(got["zmode"]) == jpar.sharded_auto_mode_select(a, b, jmesh).value
    # the fallback cases really fall back; the padded one stays int8
    assert str(got["dgemm_fallback_mode"]) == str(got["zdgemm_fallback_mode"]) == "dgemm"
    assert str(got["auto_padded_mode"]).startswith("fp64_int8_")
    for name in ("dgemm_fallback", "zdgemm_fallback", "auto_padded"):
        a, b, _ = cases.operands(cases.SPECS_2x2[name])
        assert str(got[f"{name}_mode"]) == jpar.sharded_auto_mode_select(a, b, jmesh).value


@pytest.mark.parametrize("mesh_spec", ["1x4", "4x1"])
def test_ring_rejects_rectangular_mesh(launches, mesh_spec):
    got = _case(launches, mesh_spec, "ring_rejects_rectangular")
    assert "square" in str(got["raised"]) and "square" in str(got["zraised"])
    jmesh = _jax_mesh(mesh_spec)
    for make in (jpar.sharded_gemm_ring_fn, jpar.sharded_zgemm_ring_fn):
        with pytest.raises(ValueError, match="square"):
            make(jmesh, 9, 128)


def test_replicated_roundtrip(launches):
    got = _case(launches, "2x2", "replicated_roundtrip")
    x = cases.replicated_input()
    np.testing.assert_array_equal(_u64(got["out"]), _u64(x))
    assert tuple(got["local_shape"]) == (8, 12)
    jx = jlaunch.replicated_f64x(x, _jax_mesh("2x2"), P("x", "y"))
    np.testing.assert_array_equal(_u64(jlaunch.allgather_f64x(jx).reshape(16, 24)), _u64(x))


def test_shard_local_fills_once_per_rank(launches):
    got = _case(launches, "2x2", "shard_local")
    full = cases.shard_local_input()
    np.testing.assert_array_equal(_u64(got["out"]), _u64(full))
    assert all(int(r["shard_local/calls"]) == 1 for r in launches("2x2"))
    jx = jlaunch.shard_local_f64x((32, 64), _jax_mesh("2x2"), P("x", "y"), lambda i: full[i])
    np.testing.assert_array_equal(_u64(jx.to_numpy().reshape(32, 64)), _u64(full))


def _jax_sharded(jmesh, x):
    return jlaunch.shard_local_f64x(x.shape, jmesh, P("x", "y"), lambda i: x[i])


def test_presharded_gemm_bitwise(launches):
    got = _case(launches, "2x2", "presharded")
    fa, fb, _ = cases.presharded_inputs(91, 32, 64, 32)
    assert tuple(got["shape"]) == (32, 32)
    jmesh = _jax_mesh("2x2")
    want = jpar.sharded_gemm_presharded(_jax_sharded(jmesh, fa), _jax_sharded(jmesh, fb), 9, jmesh)
    np.testing.assert_array_equal(_u64(got["out"]), _u64(want.to_numpy().reshape(32, 32)))
    np.testing.assert_array_equal(_u64(got["out"]),
                                  _u64(ozt.gemm(fa, fb, mode="fp64_int8_9", device="cpu")))


def test_presharded_gemm_epilogue(launches):
    got = _case(launches, "2x2", "presharded_epilogue")
    fa, fb, fc = cases.presharded_inputs(92, 16, 32, 16, with_c=True)
    jmesh = _jax_mesh("2x2")
    want = jpar.sharded_gemm_presharded(_jax_sharded(jmesh, fa), _jax_sharded(jmesh, fb), 9,
                                        jmesh, alpha=1.5, beta=-0.5, c=_jax_sharded(jmesh, fc))
    np.testing.assert_array_equal(_u64(got["out"]), _u64(want.to_numpy().reshape(16, 16)))
    local_ = ozt.gemm(fa, fb, mode="fp64_int8_9", alpha=1.5, beta=-0.5, c=fc, device="cpu")
    np.testing.assert_array_equal(_u64(got["out"]), _u64(local_))


def test_presharded_rejects_indivisible(launches):
    got = _case(launches, "2x2", "presharded_rejects_indivisible")
    assert "divide the mesh" in str(got["raised"])


def test_presharded_zgemm_conj_bitwise(launches):
    got = _case(launches, "2x2", "presharded_zgemm_conj")
    za, zb, _ = cases.presharded_inputs(93, 16, 32, 16, cx=True)
    jmesh = _jax_mesh("2x2")
    jre, jim = jpar.sharded_zgemm_presharded(
        _jax_sharded(jmesh, za.real.copy()), _jax_sharded(jmesh, za.imag.copy()),
        _jax_sharded(jmesh, zb.real.copy()), _jax_sharded(jmesh, zb.imag.copy()), 9, jmesh,
        conj_b=True)
    np.testing.assert_array_equal(_u64(got["re"]), _u64(jre.to_numpy().reshape(16, 16)))
    np.testing.assert_array_equal(_u64(got["im"]), _u64(jim.to_numpy().reshape(16, 16)))
    want = ozt.gemm(za, np.conj(zb), mode="fp64_int8_9", device="cpu")
    np.testing.assert_array_equal(_u64(got["re"]), _u64(want.real))
    np.testing.assert_array_equal(_u64(got["im"]), _u64(want.imag))


def test_presharded_rechecks_the_budget(launches, monkeypatch):
    """Under this budget the chooser says "k", which pre-sharded 2-D
    operands cannot use.  The JAX package runs "summa" then, over the
    budget; the port takes "stream", which fits, with the same bits."""
    from ozimmu_tpu_torch.parallel import gemm as tpar

    got = _case(launches, "1x4", "presharded_rechecks_budget")
    m, k, n = cases.RECHECK_SHAPE
    budget = cases.RECHECK_BUDGET_MB << 20
    monkeypatch.setenv("OZIMMU_HBM_BUDGET_MB", str(cases.RECHECK_BUDGET_MB))
    jmesh = _jax_mesh("1x4")
    assert str(got["select_variant"]) == jpar.select_variant(m, n, k, 9, jmesh) == "k"
    assert jpar.summa_device_bytes(m, n, k, 9, 1, 4) > budget  # the JAX package's choice
    assert str(got["variant"]) == "stream"
    assert tpar.stream_device_bytes(m, n, k, 9, 1, 4) <= budget
    fa, fb, _ = cases.presharded_inputs(94, m, k, n)
    want = jpar.sharded_gemm_presharded(_jax_sharded(jmesh, fa), _jax_sharded(jmesh, fb), 9, jmesh)
    np.testing.assert_array_equal(_u64(got["out"]), _u64(want.to_numpy().reshape(m, n)))
    np.testing.assert_array_equal(_u64(got["out"]),
                                  _u64(ozt.gemm(fa, fb, mode="fp64_int8_9", device="cpu")))


def test_each_rank_plans_with_its_share_of_the_memory(launches):
    """Four ranks on one host share its memory: ``sharded_gemm``,
    ``sharded_gemm_auto`` and the pre-sharded entry each plan with a
    quarter of the budget on every rank (the variant, the column panels
    and the epilogue's row blocks alike)."""
    for r in launches("2x2"):
        assert int(r["budget_share/count"]) == 4
        quarter = int(r["budget_share/whole"]) // 4
        assert list(r["budget_share/read"]) == [quarter, quarter]  # auto, pre-sharded
        assert list(r["budget_share/sharers"]) == [4, 4]  # sharded_gemm, auto
