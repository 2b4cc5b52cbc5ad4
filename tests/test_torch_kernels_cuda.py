"""The CUDA kernels against their plain PyTorch versions, bitwise, on the
GPU.  Marked ``cuda``: without a GPU every test here skips.  Run on the
GPU machine with ``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(the suite's conftest imports jax, which that machine need not have)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ozimmu_tpu_torch.ops import recombine as R  # noqa: E402
from ozimmu_tpu_torch.ops import recombine_cuda, split_cuda  # noqa: E402
from ozimmu_tpu_torch.ops import split as S  # noqa: E402
from ozimmu_tpu_torch.schedule import bits_per_int8  # noqa: E402
from ozimmu_tpu_torch.testing import generate_input  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _special():
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, 5] = -1e-300
    return x


@pytest.mark.parametrize("name", ["normal01", "exp_rand-8", "special"])
@pytest.mark.parametrize("ns,b", [(3, 7), (9, 7), (18, 7), (3, 5), (9, 5), (18, 5)])
def test_split_kernel_equals_plain(dev, name, ns, b):
    x_np = _special() if name == "special" else generate_input(name, (1000, 1234), seed=1)
    x = torch.from_numpy(x_np).to(dev)
    for axis in (0, 1):
        e = S.row_exponent(x, axis)
        want, _ = S.split_with_row_exp(x, e, ns, b, axis)
        got = split_cuda.split_digits(x, e, ns, b, axis)
        assert torch.equal(want, got), (name, ns, b, axis)


@pytest.mark.parametrize(
    "m,n,k,ns",
    [(200, 136, 272, 6), (256, 128, 1024, 8), (1000, 1234, 777, 9), (64, 64, 16384, 9)],
)
def test_recombine_kernel_equals_plain(dev, m, n, k, ns):
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("normal01", (m, k), seed=m)).to(dev)
    bm = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=n)).to(dev)
    da, _ = S.split_f64(a, ns, b)
    db, _ = S.split_f64_cols(bm, ns, b)
    want = R.fold_group_totals(R.group_totals(da, db, ns, k, b), ns, k, b)
    got = recombine_cuda.recombine(da, db, ns, b, k)
    for w, g in zip(want, got):
        assert torch.equal(w.view(torch.int32), g.view(torch.int32))
