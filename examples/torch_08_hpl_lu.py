"""HPL-class LU solver on the engine (``ozimmu_tpu_torch.linalg``).

The PyTorch/CUDA counterpart of ``08_hpl_lu.py``:

    python examples/torch_08_hpl_lu.py [--device cuda|cpu] [--n 1024]

The reference library exists to accelerate exactly this workload: an FP64
LU-based solver whose O(n^3) trailing-matrix GEMM updates run on the int8
matrix engine (its LD_PRELOAD shim intercepts HPL's cublasDgemm_v2 calls).
Here the solver is a native capability:

  * lu_factor: blocked right-looking LU with partial pivoting; the panels
    are factored on the host (scipy), the trailing updates go through
    ``ozt.gemm(alpha=-1, beta=1, c=A22)`` on ``--device``.
  * solve(..., refine=k): HPL-AI recipe — factor in a CHEAP mode (fewer
    int8 slices = proportionally faster), recover full f64 accuracy with
    f64-residual refinement against the cheap factors.

Without a GPU it stops at once unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.linalg import lu_factor, solve  # noqa: E402


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    return dev


def scaled_residual(A, x, b) -> float:
    """HPL's scaled residual ||Ax - b|| / (||A|| ||x|| + ||b||)."""
    return np.linalg.norm(A @ x - b) / (np.linalg.norm(A) * np.linalg.norm(x) + np.linalg.norm(b))


def main(device="cuda", n=1024, block=256) -> dict:
    dev = _device(device)
    rng = np.random.default_rng(0)
    A = rng.uniform(-1, 1, size=(n, n)) + 4.0 * np.eye(n)
    x_true = rng.standard_normal(n)
    b = A @ x_true

    def resid(x):
        return scaled_residual(A, x, b)

    # full-accuracy factorization: ns=9 GEMM updates are at the f64 floor
    x9 = solve(A, b, mode="fp64_int8_9", block=block, device=dev)
    print(f"fp64_int8_9 direct solve:        residual = {resid(x9):.3e}")

    # HPL-AI: factor ONCE at ns=5 (15 pair products vs ns=9's 45 = 3x
    # cheaper), then refinement steps (O(n^2) each) recover working precision
    fac5 = ozt.linalg.lu_factor(A, mode="fp64_int8_5", block=block, device=dev)
    x5 = solve(A, b, factor=fac5)
    print(f"fp64_int8_5 direct solve:        residual = {resid(x5):.3e}")
    refined = {}
    for k in (1, 2, 3):
        refined[k] = solve(A, b, factor=fac5, refine=k)
        print(f"fp64_int8_5 + {k} refinement step: residual = {resid(refined[k]):.3e}")

    # factor once, reuse for many right-hand sides
    fac = lu_factor(A, mode="fp64_int8_9", block=block, device=dev)
    B = rng.standard_normal((n, 4))
    X = ozt.linalg.lu_solve(fac, B)
    multi = max(np.linalg.norm(A @ X[:, j] - B[:, j]) / np.linalg.norm(B[:, j])
                for j in range(4))
    print("multi-rhs max residual:", multi)
    # the same, scaled as resid() scales it (cond(A) is ~7e3 at n = 1024, so
    # the unscaled figure sits near LAPACK's own, ~4e-12)
    multi_scaled = max(scaled_residual(A, X[:, j], B[:, j]) for j in range(4))
    print("multi-rhs max scaled residual:", multi_scaled)
    return dict(A=A, b=b, B=B, x9=x9, fac5=fac5, x5=x5, refined=refined, fac=fac, X=X,
                residual_9=resid(x9), residual_5=resid(x5),
                residual_refined={k: resid(x) for k, x in refined.items()},
                multi_rhs_residual=multi, multi_rhs_scaled_residual=multi_scaled)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.n)
