"""AUTO's estimator kernel (csrc/mantissa_loss.cu) against its plain
PyTorch version, bit for bit, on the GPU: the int64 [16] totals by rows
and by columns at b = 5, 6, 7, on the operands that reach its corners, the
totals-only entry with a given group maximum, and one decision's launches,
kernel names and read-backs.  Marked ``cuda``: without a GPU every test
here skips.  Run on the GPU machine with ``python -m pytest --noconftest
tests/test_torch_mantissa_loss_cuda.py`` (the suite's conftest imports
jax, which that machine need not have)."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu_torch.core.bits import exponent_field  # noqa: E402
from ozimmu_tpu_torch.ops import mantissa_loss as ML  # noqa: E402
from ozimmu_tpu_torch.ops import mantissa_loss_cuda  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _special():
    """Zeros, -0.0, subnormals 5e-324 and -1e-310, 1e300, a zero row and a
    zero column, and a row of subnormals (group maximum field 0)."""
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, :] = -0.0
    x[6, :] = 1e-310
    x[:, 7] = 5e-324
    return x


def _matrices():
    """name -> float64 numpy matrix: the corners, the exp_rand spreads, and
    sizes that are multiples of no tile."""
    mats = {"special": _special()}
    for phi in ("0.5", "2", "4"):
        mats[f"exp_rand-{phi}"] = generate_input(f"exp_rand-{phi}", (1000, 777), seed=7)
    mats["3x8193"] = generate_input("exp_rand-2", (3, 8193), seed=8)
    mats["8193x3"] = generate_input("exp_rand-2", (8193, 3), seed=9)
    mats["1x1"] = np.array([[1.5]])
    return mats


MATS = _matrices()


def _plain(x: torch.Tensor, b: int, axis: int) -> torch.Tensor:
    return ML.loss_totals_plain(x, torch.amax(exponent_field(x), dim=axis), b, axis)


@pytest.mark.parametrize("name", sorted(MATS))
@pytest.mark.parametrize("b", [5, 6, 7])
def test_kernel_totals_equal_plain(dev, name, b):
    x = torch.from_numpy(MATS[name]).to(dev)
    for axis in (0, 1):
        before = mantissa_loss_cuda.LAUNCHES
        got = mantissa_loss_cuda.loss_totals(x, b, axis)
        assert mantissa_loss_cuda.LAUNCHES == before + 1
        assert got.dtype == torch.int64 and got.shape == (16,) and got.device == x.device
        assert torch.equal(got, _plain(x, b, axis)), (name, axis, b)
        assert torch.equal(got.cpu(), _plain(x.cpu(), b, axis))


@pytest.mark.parametrize("b", [0, 1, 5, 6, 7])
def test_kernel_totals_through_views_and_layouts(dev, b):
    """Transposed and strided views, a column panel, the flattened batched
    and complex layouts the AUTO sites pass, and a 3-D batch."""
    wide = torch.from_numpy(generate_input("exp_rand-2", (1000, 1234), seed=1)).to(dev)
    batch = torch.from_numpy(generate_input("exp_rand-4", (3, 300, 777), seed=4)).to(dev)
    batch[0, 5, :] = 0.0
    batch[1, :, 7] = 0.0
    z = torch.from_numpy(generate_input("exp_rand-2", (333, 555), seed=5, complex_=True)).to(dev)
    views = {
        "transposed": wide.t(),
        "rows strided": wide[::3],
        "columns strided": wide[:, ::2],
        "panel[:, 3:700]": wide[:, 3:700],
        "panel[:, 64:1000]": wide[:, 64:1000],
        "batched A flattened": batch.reshape(-1, 777),
        "batched B flattened": batch.transpose(1, 2).reshape(-1, 300),
        "complex real plane": z.real.contiguous(),
        "complex imaginary plane": z.imag.contiguous(),
        "complex real view": z.real,
    }
    for name, x in views.items():
        for axis in (0, 1):
            assert torch.equal(mantissa_loss_cuda.loss_totals(x, b, axis),
                               _plain(x.contiguous(), b, axis)), (name, axis)
    for axis in (0, 1):
        want = sum(_plain(m, b, axis) for m in batch)
        assert torch.equal(mantissa_loss_cuda.loss_totals(batch, b, axis), want), axis


@pytest.mark.parametrize("shift", [3, -60])
@pytest.mark.parametrize("b", [5, 6, 7])
def test_kernel_totals_against_an_external_group_exponent(dev, shift, b):
    """The totals-only entry: a given group maximum moved up, or far down so
    that some elements need fewer than 0 bits (clamped), and zero groups."""
    x = torch.from_numpy(generate_input("exp_rand-4", (1000, 777), seed=3)).to(dev)
    x[:, 5] = 0.0
    for axis in (0, 1):
        e = torch.clamp(torch.amax(exponent_field(x), dim=axis) + shift, min=1)
        e[::5] = 0
        want = ML.loss_totals_plain(x, e, b, axis)
        assert torch.equal(ML.loss_totals_with_group_exp(x, e, b, axis), want), axis
        assert torch.equal(mantissa_loss_cuda.loss_totals(x, b, axis, e_group=e.contiguous()),
                           want), axis


def test_operands_add_into_one_buffer(dev):
    a = torch.from_numpy(MATS["exp_rand-2"]).to(dev)
    b = torch.from_numpy(MATS["special"]).to(dev)
    out = mantissa_loss_cuda.loss_totals(a, 7, 1)
    assert mantissa_loss_cuda.loss_totals(b, 7, 0, out=out) is out
    assert torch.equal(out, _plain(a, 7, 1) + _plain(b, 7, 0))
    empty = torch.empty((0, 5), dtype=torch.float64, device=dev)
    before = mantissa_loss_cuda.LAUNCHES
    assert torch.equal(mantissa_loss_cuda.loss_totals(empty, 7, 1), torch.zeros_like(out))
    assert mantissa_loss_cuda.LAUNCHES == before


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof.events()


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_a_decision_launches_only_mantissa_loss_kernels_and_reads_back_once(dev, kind):
    """One decision of ``auto_mode_select`` (A and B) or
    ``auto_mode_select_complex`` (four planes): one launch an operand, every
    kernel named ``mantissa_loss``, one device-to-host copy, counted as a
    "kernel" decision; the mode is the plain totals' mode."""
    a = torch.from_numpy(generate_input("exp_rand-2", (512, 640), seed=11)).to(dev)
    b = torch.from_numpy(generate_input("exp_rand-2", (640, 384), seed=12)).to(dev)
    if kind == "real":
        args = (a, b)
        select = ML.auto_mode_select
        operands, denom = ((a, 1), (b, 0)), a.numel() + b.numel()
    else:
        args = (a, a / 3, b, b * 5)
        select = ML.auto_mode_select_complex
        operands, denom = ((a, 1), (a / 3, 1), (b, 0), (b * 5, 0)), 2 * (a.numel() + b.numel())
    select(*args, 640, 1e-4)  # warm: the library's load and the profiler's own set-up
    paths, launches = Counter(ML.PATHS), mantissa_loss_cuda.LAUNCHES
    mode, events = _profiled(lambda: select(*args, 640, 1e-4))
    assert Counter(ML.PATHS) - paths == Counter({"kernel": 1})
    assert mantissa_loss_cuda.LAUNCHES - launches == len(operands)
    kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(kernels) == len(operands) and all("mantissa_loss" in k for k in kernels), kernels
    assert sum(e.name == "cudaMemcpyAsync" for e in events) == 1
    want = sum(_plain(x, bits_per_int8(640), axis) for x, axis in operands).cpu().numpy()
    assert mode is ML.select_mode_from_totals(want, float(denom), 1e-4)
