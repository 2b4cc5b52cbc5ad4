"""Basic emulated-FP64 GEMM on the GPU: modes, accuracy, BLAS epilogue.

The PyTorch/CUDA counterpart of ``01_basic_gemm.py``:

    python examples/torch_01_basic_gemm.py [--device cuda|cpu] [--n 2048]

Operands are numpy arrays placed on ``--device`` (default ``cuda``: the
split and recombine CUDA kernels run there; ``cpu`` runs their plain
PyTorch versions, bit for bit the same results).  Without a GPU it stops
at once unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    return dev


def main(device="cuda", n=2048) -> dict:
    dev = _device(device)
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(n, n))
    b = rng.uniform(size=(n, n))

    # plain matmul at the headline mode
    c = ozt.matmul(a, b, mode="fp64_int8_9", device=dev)
    ref = a @ b
    residual = np.linalg.norm(c - ref) / np.linalg.norm(ref)
    print("residual:", residual)

    # BLAS-style epilogue with transposes
    c2 = ozt.gemm(a, b, mode="fp64_int8_9", op_a="T", alpha=2.0, beta=1.0, c=c, device=dev)
    epilogue_ok = bool(np.allclose(c2, 2.0 * (a.T @ b) + c, rtol=1e-13))
    print("epilogue ok:", epilogue_ok)

    # data-driven split count: wide-exponent inputs need more slices
    h = n // 2
    wide = (rng.uniform(size=(h, h)) - 0.5) * np.exp(6 * rng.standard_normal((h, h)))
    # default threshold 0.0 demands error-free splits -> falls back to dgemm;
    # a small loss budget picks the smallest adequate slice count instead
    auto_exact = ozt.auto_mode_select(wide, b[:h, :h], device=dev)
    auto_budget = ozt.auto_mode_select(wide, b[:h, :h], threshold=2.0, device=dev)
    print("auto, exact (0.0):", auto_exact)
    print("auto, 2-bit budget:", auto_budget)

    # complex (ZGEMM)
    q = n // 4
    za, zb = a[:q, :q] + 1j * b[:q, :q], b[:q, :q] - 1j * a[:q, :q]
    z = ozt.gemm(za, zb, mode="fp64_int8_9", device=dev)
    print("zgemm done:", z.shape, z.dtype)
    return dict(a=a, b=b, c=c, residual=residual, c2=c2, epilogue_ok=epilogue_ok, wide=wide,
                auto_exact=auto_exact, auto_budget=auto_budget, za=za, zb=zb, z=z)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=2048)
    args = ap.parse_args()
    main(args.device, args.n)
