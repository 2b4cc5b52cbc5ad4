"""The port's interceptor (``ozimmu_tpu_torch.intercept``) against the JAX
package's (``ozimmu_tpu.intercept``) on the same numpy inputs, bitwise:
real and complex ``@``, ``tensordot``, ``einsum``, ``bmm``, ``F.linear``
with a bias, fixed split counts and eager AUTO; then the gates (per-call
env mode, thresholds, dtypes), nesting, state restore, warm-up,
``torch.compile`` frames, and one test per deviation (a)-(d) from the JAX
package (ROADMAP.md queue 3).  CPU tensors, small shapes, thresholds
lowered to 16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu.intercept as jozi  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
import ozimmu_tpu_torch.intercept as ozi  # noqa: E402
from ozimmu_tpu_torch.core import api  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

M, K, N = 40, 48, 24
TH = 16


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    ozi.disable()
    jozi.disable()


def _handles(th=TH):
    h, jh = ozt.create(device="cpu"), oz.create()
    for x in (h, jh):
        x.intercept_threshold_m = x.intercept_threshold_n = x.intercept_threshold_k = th
    return h, jh


def _u64(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.uint64)


def _same(got, want):
    np.testing.assert_array_equal(_u64(got), _u64(want))


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _jax_under(mode, jh, fn, *xs):
    """``fn`` of the numpy inputs as JAX arrays under the JAX interceptor."""
    with jozi.intercept(mode=mode, handle=jh):
        return np.asarray(fn(*[jnp.asarray(x) for x in xs]))


def _real(seed, *shapes, dist="urand01"):
    return [generate_input(dist, s, seed=seed + i) for i, s in enumerate(shapes)]


def _cplx(seed, *shapes, dist="normal01"):
    return [generate_input(dist, s, seed=seed + i, complex_=True) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("ns", [8, 9, 12])
def test_real_forms_match_jax(ns):
    """``@``, ``tensordot`` and 2-D ``einsum`` (which arrives as a batch-1
    ``bmm``) all equal the JAX interceptor's ``a @ b``."""
    a, b = _real(ns, (M, K), (K, N))
    h, jh = _handles()
    mode = f"fp64_int8_{ns}"
    want = _jax_under(mode, jh, lambda x, y: x @ y, a, b)
    ta, tb = _t(a, b)
    with ozi.intercept(mode=mode, handle=h):
        got = [ta @ tb, torch.tensordot(ta, tb, 1), torch.einsum("ik,kj->ij", ta, tb)]
    for g in got:
        _same(g, want)
    assert not np.array_equal(_u64(got[0]), _u64(ta @ tb))  # native differs: it was rerouted


def test_complex_and_conj_bit_match_jax():
    """complex128 ``a @ b`` and ``x.mH @ b`` (an ``mm`` with a conj-bit
    operand) against the JAX interceptor's ``a @ b`` and ``conj(x).T @ b``."""
    a, b, x = _cplx(20, (M, K), (K, N), (K, M))
    h, jh = _handles()
    want = _jax_under("fp64_int8_9", jh, lambda p, q, r: (p @ q, jnp.conj(r).T @ q), a, b, x)
    ta, tb, tx = _t(a, b, x)
    assert tx.mH.is_conj()
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = (ta @ tb, tx.mH @ tb)
    for g, w in zip(got, want):
        _same(torch.view_as_real(g), w.view(np.float64).reshape(*w.shape, 2))
    _same(got[1], ozt.gemm(tx, tb, mode="fp64_int8_9", op_a="C"))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_batched_matches_jax(kind):
    """Batched ``@``, ``einsum('bik,bkj->bij')`` and two batch dimensions
    (folded into one ``bmm``) against the JAX interceptor's matmul."""
    gen = _real if kind == "real" else _cplx
    a, b = gen(30, (2, 3, M, K), (2, 3, K, N))
    h, jh = _handles()
    want = _jax_under("fp64_int8_9", jh, jnp.matmul, a, b)
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = [ta @ tb, torch.einsum("xbik,xbkj->xbij", ta, tb),
               torch.bmm(ta.reshape(6, M, K), tb.reshape(6, K, N)).reshape(2, 3, M, N)]
    as_real = torch.view_as_real if kind == "complex" else (lambda t: t)
    for g in got:
        _same(as_real(g), want.view(np.float64).reshape(as_real(g).shape))


def test_linear_with_bias_matches_jax_and_backward_is_routed():
    """``F.linear`` with a bias (``aten.addmm``) against JAX ``x @ w.T + b``;
    its backward's two ``mm``s go through the engine as well."""
    x, w, bias = _real(40, (M, K), (N, K), (N,), dist="normal01")
    h, jh = _handles()
    want = _jax_under("fp64_int8_9", jh, lambda p, q, r: p @ q.T + r, x, w, bias)
    tx, tw, tb = _t(x, w, bias)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        y = torch.nn.functional.linear(tx, tw, tb)
        y.backward(torch.ones_like(y))
    _same(y.detach(), want)
    ones = torch.ones(M, N, dtype=torch.float64)
    _same(tx.grad, ozt.gemm(ones, tw.detach(), mode="fp64_int8_9"))
    _same(tw.grad, ozt.gemm(ones.T, tx.detach(), mode="fp64_int8_9"))


def test_addmm_and_baddbmm_scalars_are_native():
    """alpha and beta are applied with native ops on the routed product."""
    a, b, c = _real(45, (M, K), (K, N), (M, N))
    a3, b3, c3 = _real(48, (3, M, K), (3, K, N), (3, M, N))
    h, _ = _handles()
    ta, tb, tc, ta3, tb3, tc3 = _t(a, b, c, a3, b3, c3)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = torch.addmm(tc, ta, tb, beta=0.5, alpha=2.0)
        got3 = torch.baddbmm(tc3, ta3, tb3, beta=0.0, alpha=-1.0)
    _same(got, ozt.gemm(ta, tb, mode="fp64_int8_9") * 2.0 + tc * 0.5)
    _same(got3, ozt.gemm_batched(ta3, tb3, mode="fp64_int8_9") * -1.0)


def test_eager_auto_matches_jax():
    """AUTO picks the split count from the operands on every call, as the
    JAX interceptor's eager path (a concrete ``lax.dot_general``) does."""
    a, b = _real(50, (M, K), (K, N))
    h, jh = _handles()
    dims = (((1,), (0,)), ((), ()))
    want = _jax_under("fp64_int8_auto", jh, lambda x, y: jax.lax.dot_general(x, y, dims), a, b)
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_auto", handle=h):
        got = ta @ tb
    _same(got, want)
    chosen = ozt.auto_mode_select(ta, tb, handle=h)
    assert chosen.is_int8
    _same(got, ozt.gemm(ta, tb, mode=chosen))


def test_eager_auto_complex_matches_jax():
    a, b = _cplx(55, (M, K), (K, N), dist="exp_rand-1")
    h, jh = _handles()
    h.avg_mantissa_loss_threshold = jh.avg_mantissa_loss_threshold = 0.5
    dims = (((1,), (0,)), ((), ()))
    want = _jax_under("fp64_int8_auto", jh, lambda x, y: jax.lax.dot_general(x, y, dims), a, b)
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_auto", handle=h):
        got = ta @ tb
    _same(torch.view_as_real(got), want.view(np.float64).reshape(M, N, 2))


def test_auto_fallback_runs_native():
    """No split count meets a negative threshold: AUTO falls back to dgemm,
    and the 2-D route hands the call back to native."""
    a, b = _real(58, (M, K), (K, N))
    h, _ = _handles()
    h.avg_mantissa_loss_threshold = -1.0
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_auto", handle=h):
        got = ta @ tb
    _same(got, ta @ tb)


def test_env_mode_is_read_per_call(monkeypatch):
    a, b = _real(60, (M, K), (K, N))
    h, _ = _handles()
    ta, tb = _t(a, b)
    native = ta @ tb
    ozi.enable(handle=h)  # no pinned mode: OZIMMU_COMPUTE_MODE on each call
    monkeypatch.delenv("OZIMMU_COMPUTE_MODE", raising=False)
    _same(ta @ tb, native)  # unset: no interception
    monkeypatch.setenv("OZIMMU_COMPUTE_MODE", "dgemm")
    _same(ta @ tb, native)
    monkeypatch.setenv("OZIMMU_COMPUTE_MODE", "fp64_int8_9")
    routed = ta @ tb
    _same(routed, oz.gemm(a, b, mode="fp64_int8_9"))
    monkeypatch.setenv("OZIMMU_COMPUTE_MODE", "no_such_mode")  # unparsable: dgemm
    _same(ta @ tb, native)
    assert not np.array_equal(_u64(routed), _u64(native))


def test_thresholds_and_dtypes_gate():
    """Each dimension below its own threshold, and float32 operands, stay
    native."""
    h, _ = _handles()
    h.intercept_threshold_m, h.intercept_threshold_n, h.intercept_threshold_k = 30, 20, 40
    cases = {
        "routed": _real(70, (30, 40), (40, 20)),
        "m below": _real(70, (29, 40), (40, 20)),
        "n below": _real(70, (30, 40), (40, 19)),
        "k below": _real(70, (30, 39), (39, 20)),
    }
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = {name: torch.from_numpy(a) @ torch.from_numpy(b) for name, (a, b) in cases.items()}
        a32, b32 = (torch.from_numpy(x).float() for x in cases["routed"])
        f32 = a32 @ b32
    for name, (a, b) in cases.items():
        want = (oz.gemm(a, b, mode="fp64_int8_9") if name == "routed"
                else (torch.from_numpy(a) @ torch.from_numpy(b)).numpy())
        _same(got[name], want)
    assert torch.equal(f32, a32 @ b32)


def test_engine_calls_are_not_reintercepted(monkeypatch):
    """With every threshold at 1, the engine's own torch calls (here the
    native f64 ``matmul`` of batched AUTO's dgemm fallback) reach the
    dispatch mode no more: the route runs once per user call."""
    a, b = _real(80, (3, M, K), (3, K, N))
    h, jh = _handles(th=1)
    ta, tb = _t(a, b)
    entered = []
    route = ozi._ROUTES["bmm"]
    monkeypatch.setitem(ozi._ROUTES, "bmm", lambda *args: entered.append(1) or route(*args))
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = ta[0] @ tb[0]
    _same(got, _jax_under("fp64_int8_9", jh, lambda x, y: x @ y, a[0], b[0]))
    h.avg_mantissa_loss_threshold = -1.0
    with ozi.intercept(mode="fp64_int8_auto", handle=h):
        got = ta @ tb
    assert entered == [1]
    _same(got, torch.matmul(ta, tb))


def test_disable_and_context_restore_state():
    a, b = _real(90, (M, K), (K, N))
    h, _ = _handles()
    ta, tb = _t(a, b)
    native = ta @ tb
    ns9, ns12 = (oz.gemm(a, b, mode=f"fp64_int8_{ns}") for ns in (9, 12))
    ozi.enable(mode="fp64_int8_9", handle=h)
    _same(ta @ tb, ns9)
    with ozi.intercept(mode="fp64_int8_12", handle=h):
        _same(ta @ tb, ns12)
    _same(ta @ tb, ns9)  # the outer state is back
    ozi.disable()
    _same(ta @ tb, native)
    with ozi.intercept(mode="fp64_int8_12", handle=h):
        _same(ta @ tb, ns12)
    _same(ta @ tb, native)  # and disabled again after the block
    assert torch.utils._python_dispatch._get_current_dispatch_mode() is None


def test_warmup_on_enable(monkeypatch):
    """``warmup=True`` or ``OZIMMU_WARMUP_ON_ENABLE=1`` runs the default
    shape once: max(1024, thresholds) in each dimension."""
    h, _ = _handles()
    h.intercept_threshold_k = 2048
    ozi.enable(mode="dgemm", handle=h, warmup=True)  # a real (native) run
    ozi.disable()
    calls = []
    monkeypatch.setattr(api, "warmup", lambda *args, **kw: calls.append((args, kw)))
    monkeypatch.setenv("OZIMMU_WARMUP_ON_ENABLE", "1")
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        pass
    ozi.enable(mode="fp64_int8_12", handle=h, warmup=False)
    assert calls == [((1024, 1024, 2048, ozt.ComputeMode.FP64_INT8_9), {"handle": h})]


def test_compiled_frame_runs_intercepted():
    """``torch.compile`` without ``fullgraph`` runs a frame eagerly while
    the dispatch mode is active — a frame compiled before included."""
    a, b = _real(100, (M, K), (K, N))
    h, _ = _handles()
    ta, tb = _t(a, b)
    f = torch.compile(lambda x, y: x @ y + 1.0, backend="aot_eager")
    native = f(ta, tb)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = f(ta, tb)
    _same(got, ozt.gemm(ta, tb, mode="fp64_int8_9") + 1.0)
    assert not np.array_equal(_u64(got), _u64(native))


def test_missing_patch_point_fails_loudly(monkeypatch):
    monkeypatch.setitem(ozi._ROUTES, "no_such_op", ozi._route_2d)
    with pytest.raises(ozi.PatchPointError, match="needs porting"):
        ozi.enable(mode="fp64_int8_9")
    assert ozi._tls().dispatch is None


def test_deviation_a_folded_3d_by_2d_is_routed():
    """(a) ``[B, m, k] @ [k, n]`` reaches aten as one ``[B*m, k] @ [k, n]``
    ``mm`` and is routed; the JAX interceptor leaves that contraction
    native (its lhs is 3-D with no batch dimension)."""
    a, b = _real(110, (3, M, K), (K, N))
    h, jh = _handles()
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = ta @ tb
    _same(got, ozt.gemm(ta.reshape(3 * M, K), tb, mode="fp64_int8_9").reshape(3, M, N))
    native_jax = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
    _same(_jax_under("fp64_int8_9", jh, lambda x, y: x @ y, a, b), native_jax)


def test_deviation_b_batched_auto_uses_all_split_counts():
    """(b) Batched AUTO chooses among all 16 split counts, as the JAX host
    API ``gemm_batched`` does (here it picks 11, which the JAX
    interceptor's pruned candidates (8, 9, 10, 12, 16, 18) do not hold)."""
    a, b = _real(5, (3, M, K), (3, K, N))
    h, _ = _handles()
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_auto", handle=h):
        got = ta @ tb
    _same(got, oz.gemm_batched(a, b, mode="fp64_int8_auto", handle=oz.create()))
    _same(got, ozt.gemm_batched(ta, tb, mode="fp64_int8_11"))


def test_deviation_c_device_errors_propagate(monkeypatch, capsys):
    """(c) An engine error on a non-CPU tensor propagates; on CPU tensors
    it is logged and the call runs native, as in the JAX package."""
    h, _ = _handles()

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(api, "gemm", broken)
    a, b = _real(130, (M, K), (K, N))
    ta, tb = _t(a, b)
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        got = ta @ tb
        ma, mb = ta.to("meta"), tb.to("meta")
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            ma @ mb
    _same(got, ta @ tb)
    assert "interception fell back to native: RuntimeError" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_deviation_d_sgemm_is_demoted(kind):
    """(d) ``mode="sgemm"`` runs the f32 demotion of the reference shim;
    the JAX interceptor logs an error and runs native f64 for it."""
    gen = _real if kind == "real" else _cplx
    a, b, a3, b3 = gen(140, (M, K), (K, N), (3, M, K), (3, K, N))
    h, jh = _handles()
    ta, tb, ta3, tb3 = _t(a, b, a3, b3)
    with ozi.intercept(mode="sgemm", handle=h):
        got, got3 = ta @ tb, ta3 @ tb3
    as_real = torch.view_as_real if kind == "complex" else (lambda t: t)
    _same(as_real(got), as_real(ozt.gemm(ta, tb, mode="sgemm")))
    _same(as_real(got3), as_real(ozt.gemm_batched(ta3, tb3, mode="sgemm")))
    if kind == "real":
        native_jax = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
        _same(_jax_under("sgemm", jh, lambda x, y: x @ y, a, b), native_jax)
