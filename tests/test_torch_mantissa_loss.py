"""ozimmu_tpu_torch.ops.mantissa_loss against ozimmu_tpu.ops.mantissa_loss:
the int64 loss totals bit for bit, the histogram form against the literal
form, the complex counter, AUTO's choice and its fallback policy."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import ozimmu_tpu as oz  # noqa: E402
import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu.core.f64x import F64X  # noqa: E402
from ozimmu_tpu.ops import mantissa_loss as ref  # noqa: E402
from ozimmu_tpu_torch.core.bits import exponent_field  # noqa: E402
from ozimmu_tpu_torch.ops import mantissa_loss as port  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input, loss_totals_literal  # noqa: E402

M, K, N = 33, 47, 65


def _special():
    """Zero rows and columns, a row of subnormals (group max exponent 0),
    subnormals and +-0.0 among normals, and extreme magnitudes."""
    x = generate_input("normal01", (M, K), seed=9)
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, :] = -0.0
    x[5, 5] = 1e300
    x[6, 6] = 2.2250738585072014e-308
    x[7, :] = 1e-310
    return x


INPUTS = {
    "urand01": lambda: generate_input("urand01", (M, K), seed=1),
    "normal01": lambda: generate_input("normal01", (M, K), seed=2),
    "exp_rand-8": lambda: generate_input("exp_rand-8", (M, K), seed=3),
    "special": _special,
}


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("b", [7, 5])
def test_totals_bits_match_reference(name, axis, b):
    x = INPUTS[name]()
    t = torch.from_numpy(x)
    got = port.mantissa_loss_totals(t, b, axis)
    assert got.dtype == torch.int64 and got.shape == (16,)
    want = np.asarray(ref.mantissa_loss_totals(F64X.from_numpy(x), b, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    e = torch.amax(exponent_field(t), dim=axis)
    np.testing.assert_array_equal(loss_totals_literal(t, e, b, axis).numpy(), got.numpy())


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shift", [3, -60])
def test_totals_against_an_external_group_exponent(axis, shift):
    """The distributed estimator's split: a group maximum from outside
    (here the local one moved up, or far down so that some elements need
    fewer than 0 bits), and zero groups."""
    x = INPUTS["exp_rand-8"]()
    t = torch.from_numpy(x)
    e = torch.amax(exponent_field(t), dim=axis) + shift
    e = torch.clamp(e, min=1)
    e[::5] = 0
    got = port.loss_totals_with_group_exp(t, e, 7, axis)
    want = np.asarray(ref.loss_totals_with_group_exp(
        F64X.from_numpy(x), jnp.asarray(e.numpy()), 7, axis))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(loss_totals_literal(t, e, 7, axis).numpy(), got.numpy())


@pytest.mark.parametrize("b_is_cols", [True, False])
def test_complex_loss_totals(b_is_cols):
    a = generate_input("exp_rand-8", (M, K), seed=4, complex_=True)
    b = generate_input("normal01", (K, N) if b_is_cols else (N, K), seed=5, complex_=True)
    planes = [np.ascontiguousarray(p) for p in (a.real, a.imag, b.real, b.imag)]
    got = port.complex_loss_totals(*(torch.from_numpy(p) for p in planes), K, b_is_cols)
    want = np.asarray(ref.complex_loss_totals(*(F64X.from_numpy(p) for p in planes), K, b_is_cols))
    np.testing.assert_array_equal(got.numpy(), want)
    for thr in (0.0, 3.0, 100.0):
        assert port.auto_mode_select_complex(
            *(torch.from_numpy(p) for p in planes), K, thr, b_is_cols
        ).value == ref.auto_mode_select_complex(
            *(F64X.from_numpy(p) for p in planes), K, thr, b_is_cols).value


@pytest.mark.parametrize("dist", ["urand01", "exp_rand-8"])
@pytest.mark.parametrize("op_a,op_b", [("N", "N"), ("T", "N"), ("N", "T")])
@pytest.mark.parametrize("threshold", [0.0, 100.0])
def test_auto_mode_select_matches_reference(dist, op_a, op_b, threshold):
    a = generate_input(dist, (M, K) if op_a == "N" else (K, M), seed=6)
    b = generate_input(dist, (K, N) if op_b == "N" else (N, K), seed=7)
    want = oz.auto_mode_select(a, b, op_a=op_a, op_b=op_b, threshold=threshold).value
    got = ozt.auto_mode_select(a, b, op_a=op_a, op_b=op_b, threshold=threshold, device="cpu")
    assert got.value == want
    t = ozt.auto_mode_select(torch.from_numpy(a), torch.from_numpy(b), op_a=op_a, op_b=op_b,
                             threshold=threshold)
    assert t is got


def test_auto_mode_select_reads_the_handle_threshold():
    a = generate_input("urand01", (M, K), seed=8)
    b = generate_input("urand01", (K, N), seed=9)
    h = ozt.create(device="cpu")
    ozt.set_auto_mantissa_loss_threshold(h, 100.0)
    assert ozt.get_auto_mantissa_loss_threshold(h) == 100.0
    assert ozt.auto_mode_select(a, b, handle=h) is ozt.ComputeMode.FP64_INT8_3
    with pytest.raises(TypeError, match="real"):
        ozt.auto_mode_select(a + 1j, b, handle=h)


@pytest.mark.parametrize("env,mode", [
    ("dgemm", ozt.ComputeMode.DGEMM),
    ("native", ozt.ComputeMode.DGEMM),
    ("int8_18", ozt.ComputeMode.FP64_INT8_18),
    ("deepest", ozt.ComputeMode.FP64_INT8_18),
    ("auto", ozt.ComputeMode.DGEMM),
    (None, ozt.ComputeMode.DGEMM),
])
def test_auto_fallback_policy(monkeypatch, capsys, env, mode):
    """Torch has IEEE f64 on every device: the policy is dgemm; the env
    overrides it; the choice is logged."""
    if env is None:
        monkeypatch.delenv("OZIMMU_AUTO_FALLBACK", raising=False)
    else:
        monkeypatch.setenv("OZIMMU_AUTO_FALLBACK", env)
    monkeypatch.setenv("OZIMMU_INFO", "1")
    assert port.auto_fallback_mode() is mode
    assert ref.auto_fallback_mode().value == mode.value  # the JAX package on its CPU backend
    assert f"falling back to {mode.value}" in capsys.readouterr().out
    totals = np.full(16, 10, dtype=np.int64)
    assert port.select_mode_from_totals(totals, 1.0, 5.0) is mode
    assert port.select_mode_from_totals(totals, 1.0, 10.0) is ozt.ComputeMode.FP64_INT8_3


def test_fallback_to_int8_18_runs_it(monkeypatch):
    """Operands AUTO rejects at threshold 0: with OZIMMU_AUTO_FALLBACK=int8_18
    both packages run fp64_int8_18, bit for bit."""
    monkeypatch.setenv("OZIMMU_AUTO_FALLBACK", "int8_18")
    a = generate_input("exp_rand-8", (M, K), seed=10)
    b = generate_input("exp_rand-8", (K, N), seed=11)
    assert ozt.auto_mode_select(a, b, threshold=0.0, device="cpu") is ozt.ComputeMode.FP64_INT8_18
    got = ozt.gemm(a, b, device="cpu", handle=ozt.create(device="cpu"))
    want = oz.gemm(a, b, handle=oz.create())
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


# ---------------------------------------------------------------------------
# the kernel's side, as far as the CPU can reach it: its arithmetic
# (csrc/mantissa_loss.cu) modelled in numpy, its launch plan, the dispatch
# by device, the decisions' count by path, the wrapper's refusals
# ---------------------------------------------------------------------------

from collections import Counter  # noqa: E402

from ozimmu_tpu_torch.ops import mantissa_loss_cuda  # noqa: E402

_ZERO = 0xFFFF  # the kernel's kept code of a value that is exactly zero


def _kernel_model(x: np.ndarray, b: int, axis: int, e_group=None) -> np.ndarray:
    """The kernel's arithmetic on a float64 matrix: each element's code (the
    exponent field, or the zero mark), the group maximum of the fields (or
    ``e_group``), base = eg + 54 (0 where eg <= 0) in int32, r = base - code
    kept where positive and the code is not the zero mark, and the totals
    as sum(r) - sum(min(r, ns*b))."""
    bits = x.view(np.uint64)
    fields = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    codes = np.where((bits << np.uint64(1)) != 0, fields, _ZERO)
    eg = fields.max(axis=axis) if e_group is None else np.asarray(e_group, dtype=np.int64)
    base = np.where(eg > 0, (eg + 54 + 2**31) % 2**32 - 2**31, 0)
    base = base[:, None] if axis == 1 else base[None, :]
    r = (base - codes + 2**31) % 2**32 - 2**31
    r = np.where((codes != _ZERO) & (r > 0), r, 0)
    space = np.arange(3, 19, dtype=np.int64) * b
    return np.array([r.sum() - np.minimum(r, s).sum() for s in space], dtype=np.int64)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("b", [0, 1, 5, 6, 7])
def test_the_kernels_arithmetic_equals_the_histogram(name, axis, b):
    """sum(r) - sum(min(r, ns*b)) over the kernel's codes is the plain
    histogram's totals, at every digit width the kernel instantiates."""
    t = torch.from_numpy(INPUTS[name]())
    e = torch.amax(exponent_field(t), dim=axis)
    want = port.loss_totals_plain(t, e, b, axis).numpy()
    np.testing.assert_array_equal(_kernel_model(t.numpy(), b, axis), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shift", [3, -60])
def test_the_kernels_arithmetic_against_an_external_group_exponent(axis, shift):
    """With a given group maximum, zero groups and some required below 0."""
    t = torch.from_numpy(INPUTS["special"]())
    e = torch.clamp(torch.amax(exponent_field(t), dim=axis) + shift, min=1)
    e[::5] = 0
    want = port.loss_totals_plain(t, e, 7, axis).numpy()
    np.testing.assert_array_equal(_kernel_model(t.numpy(), 7, axis, e.numpy()), want)


def test_cpu_tensors_take_the_plain_path_and_add_into_out():
    x = torch.from_numpy(INPUTS["exp_rand-8"]())
    e = torch.amax(exponent_field(x), dim=0)
    plain = port.loss_totals_plain(x, e, 7, 0)
    assert torch.equal(port.mantissa_loss_totals(x, 7, 0), plain)
    assert torch.equal(port.loss_totals_with_group_exp(x, e, 7, 0), plain)
    out = plain.clone()
    assert port.mantissa_loss_totals(x, 7, 0, out=out) is out
    assert torch.equal(out, 2 * plain)


def test_cpu_decisions_count_the_torch_path(monkeypatch):
    """Each decision on CPU tensors counts once under "torch", never under
    "kernel", and never reaches the kernel's wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU decision reached the CUDA wrapper")

    monkeypatch.setattr(mantissa_loss_cuda, "loss_totals", refuse)
    before = Counter(port.PATHS)
    a = torch.from_numpy(generate_input("urand01", (M, K), seed=12))
    b = torch.from_numpy(generate_input("urand01", (K, N), seed=13))
    port.auto_mode_select(a, b, K, 0.0)
    planes = [torch.from_numpy(np.ascontiguousarray(p)) for p in (a.numpy(), a.numpy() / 3,
                                                                   b.numpy(), b.numpy() * 5)]
    port.auto_mode_select_complex(*planes, K, 0.0)
    ozt.gemm(a.numpy(), b.numpy(), mode="fp64_int8_auto", device="cpu")
    assert Counter(port.PATHS) - before == Counter({"torch": 3})


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_wrapper_refuses_what_is_not_on_the_card(device):
    x = torch.zeros(4, 4, dtype=torch.float64, device=device)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mantissa_loss_cuda.loss_totals(x, 7, 1)


class _FakeCuda:
    """Just enough of a CUDA float64 tensor for the wrapper's checks, which
    come before anything touches the card."""

    def __init__(self, dtype=torch.float64, shape=(8, 8)):
        self.device = torch.device("cuda", 0)
        self.dtype = dtype
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("x,b,axis,kw,match", [
    (_FakeCuda(torch.float32), 7, 1, {}, "float64"),
    (_FakeCuda(torch.int64), 7, 1, {}, "float64"),
    (_FakeCuda(shape=(2, 2, 2, 2)), 7, 1, {}, "2-D or 3-D"),
    (_FakeCuda(), 7, 2, {}, "axis"),
    (_FakeCuda(), 8, 1, {}, "b must be"),
    (_FakeCuda(), -1, 0, {}, "b must be"),
    (_FakeCuda(), 7, 1, {"out": torch.zeros(16, dtype=torch.int32)}, "out must be"),
    (_FakeCuda(), 7, 1, {"out": torch.zeros(16, dtype=torch.int64)}, "out must be"),
    (_FakeCuda(), 7, 1, {"e_group": torch.zeros(8, dtype=torch.int64)}, "e_group must be"),
    (_FakeCuda(), 7, 0, {"e_group": torch.zeros(7, dtype=torch.int32)}, "e_group must be"),
])
def test_the_wrapper_refuses_wrong_types_and_shapes(x, b, axis, kw, match):
    with pytest.raises(ValueError, match=match):
        mantissa_loss_cuda.loss_totals(x, b, axis, **kw)


def test_the_launch_plan_at_the_auto_cells_shape():
    """8192^2 on 132 SMs: A by rows on whole blocks, 16 words a thread kept,
    read once; B by strips of 4 columns, 64 words a thread, read once."""
    rows = mantissa_loss_cuda.loss_plan(1, 8192, 8192, 1, True, 132)
    assert (rows.width, rows.staged, rows.load16) == (8, 16, True)
    assert rows.grid == 132 * mantissa_loss_cuda.ROW_BLOCKS_PER_SM
    assert rows.smem_bytes == 16 * 256 * 4
    cols = mantissa_loss_cuda.loss_plan(1, 8192, 8192, 0, True, 132)
    assert (cols.width, cols.staged, cols.grid) == (4, 64, 2048)
    assert cols.smem_bytes == 64 * 1024


@pytest.mark.parametrize("batch,rows,cols,axis", [
    (1, 1000, 777, 1), (1, 1000, 777, 0), (1, 3, 8193, 1), (1, 8193, 3, 0), (1, 3, 8193, 0),
    (4, 300, 777, 1), (4, 777, 300, 0), (1, 1, 1, 0), (1, 1, 1, 1), (2, 16, 129, 0),
    (1, 65536, 64, 0), (1, 64, 65536, 1), (1, 100000, 2, 0),
])
def test_the_launch_plan_keeps_within_the_kernels_limits(batch, rows, cols, axis):
    """Widths within the kernel's limits, the staged words within the
    shared memory given, and the threads' steps covering the groups: a row's
    threads take 2 * 32 * width elements a step; a strip of STRIP columns
    takes THREADS / (STRIP / 2) rows a step."""
    for external in (False, True):
        p = mantissa_loss_cuda.loss_plan(batch, rows, cols, axis, False, 132, external)
        assert p.threads == 256 and 1 <= p.grid < 2**31
        assert p.staged == 0 if external else 0 < p.staged <= mantissa_loss_cuda.STAGE_WORDS
        assert p.smem_bytes == p.staged * 256 * 4
        if axis == 1:
            assert p.width in (1, 2, 4, 8)
            per_thread = -(-cols // (64 * p.width))
            assert per_thread <= mantissa_loss_cuda.ROW_WORDS or p.width == 8
            assert p.grid <= -(-batch * rows // (8 // p.width))
        else:
            assert p.width == mantissa_loss_cuda.STRIP == 4
            assert p.grid == batch * -(-cols // 4)
            per_thread = -(-rows // 128)
        assert external or p.staged == min(per_thread, mantissa_loss_cuda.STAGE_WORDS)


def test_the_launch_plan_refuses_what_the_kernel_cannot_sum():
    with pytest.raises(ValueError, match="overflow"):
        mantissa_loss_cuda.loss_plan(1, 1, 2**36, 1, True, 132)
    with pytest.raises(ValueError, match="no mantissa-loss launch"):
        mantissa_loss_cuda.loss_plan(1, 0, 8, 1, True, 132)
