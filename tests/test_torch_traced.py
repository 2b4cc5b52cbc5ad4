"""The port's ``torch.compile`` surface (``ozimmu_tpu_torch.traced``)
against the JAX package's jittable one (``ozimmu_tpu.traced``) on the same
numpy inputs, bitwise: each custom op passes ``torch.library.opcheck``,
and ``torch.compile(fullgraph=True)`` of each function equals
``jax.jit`` of its JAX counterpart.  CPU tensors, small shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu.traced as jtraced  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch import traced  # noqa: E402

M, K, N = 24, 40, 16


def _mk(shape, seed, complex_=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    return x + 1j * rng.normal(size=shape) if complex_ else x


def _bits(x):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint64)


def _compiled(fn):
    return torch.compile(fn, backend="aot_eager", fullgraph=True)


@pytest.mark.parametrize("case", ["real", "complex", "batched"])
def test_opcheck(case):
    cx = case == "complex"
    a, b, c = (torch.from_numpy(_mk(s, i, cx)) for i, s in enumerate([(M, K), (K, N), (M, N)]))
    if case == "batched":
        stack = lambda t: torch.stack([t, 2 * t])  # noqa: E731
        args = (stack(a), stack(b), stack(c), 9, 1.5, 0.0, -0.5, 0.0)
        op = torch.ops.ozimmu_tpu_torch.gemm_batched.default
    else:
        args = (a, b, c, 9, 1.5, -0.5 if cx else 0.0, 0.25, 1.0 if cx else 0.0, None)
        op = torch.ops.ozimmu_tpu_torch.gemm.default
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("kw", [{}, {"num_split": 12, "alpha": 2.5, "beta": -0.5},
                                {"num_split": 8, "n_chunks": 3}])
def test_compiled_real_matches_jax_jit(kw):
    a, b, c = _mk((M, K), 0), _mk((K, N), 1), _mk((M, N), 2)
    want = jax.jit(lambda x, y, z: jtraced.gemm(x, y, c=z, **kw))(a, b, c)
    got = _compiled(lambda x, y, z: traced.gemm(x, y, c=z, **kw))(
        *(torch.from_numpy(t) for t in (a, b, c)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_compiled_complex_matches_jax_jit():
    a, b, c = (_mk(s, 10 + i, True) for i, s in enumerate([(M, K), (K, N), (M, N)]))
    kw = dict(num_split=10, alpha=1.5 - 0.5j, beta=0.25 + 1.0j)
    want = jax.jit(lambda x, y, z: jtraced.gemm(x, y, c=z, **kw))(a, b, c)
    got = _compiled(lambda x, y, z: traced.gemm(x, y, c=z, **kw))(
        *(torch.from_numpy(t) for t in (a, b, c)))
    want = np.asarray(want).view(np.float64).reshape(M, N, 2)
    np.testing.assert_array_equal(_bits(torch.view_as_real(got)), _bits(want))


def test_compiled_batched_matches_jax_jit():
    a, b, c = _mk((3, M, K), 20), _mk((3, K, N), 21), _mk((3, M, N), 22)
    want = jax.jit(lambda x, y, z: jtraced.gemm_batched(x, y, alpha=2.0, beta=1.0, c=z))(a, b, c)
    got = _compiled(lambda x, y, z: traced.gemm_batched(x, y, alpha=2.0, beta=1.0, c=z))(
        *(torch.from_numpy(t) for t in (a, b, c)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_composes_inside_compiled_code():
    """The engine inside a larger compiled function: a matmul, then a
    second product of its result, around native ops."""
    a, b = (torch.from_numpy(_mk((32, 32), 30 + i)) for i in range(2))

    def f(x, y):
        g = traced.matmul(x, y)
        return torch.trace(g) + traced.gemm(g, y, alpha=0.5)[0, 0]

    got = _compiled(f)(a, b)
    g = ozt.gemm(a, b, mode="fp64_int8_9")
    want = torch.trace(g) + ozt.gemm(g, b, mode="fp64_int8_9", alpha=0.5)[0, 0]
    assert _bits(got) == _bits(want)


def test_validation():
    a, b = torch.from_numpy(_mk((8, 8), 40)), torch.from_numpy(_mk((9, 8), 41))
    with pytest.raises(ValueError, match="mismatch"):
        traced.gemm(a, b)
    with pytest.raises(ValueError, match="2D"):
        traced.gemm(a[None], a)
    with pytest.raises(ValueError, match="requires c"):
        traced.gemm(a, a, beta=1.0)
    with pytest.raises(ValueError, match="3D"):
        traced.gemm_batched(a, a)
    with pytest.raises(ValueError, match="requires c"):
        traced.gemm_batched(a[None], a[None], beta=1.0)
    with pytest.raises(ValueError, match="mismatch"):
        traced.gemm_batched(a[None], b[None])
    with pytest.raises(TypeError):
        traced.gemm(a, a, alpha=1j)  # a complex scalar on real operands
