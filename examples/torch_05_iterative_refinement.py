"""Mixed-precision iterative refinement: the classic consumer of emulated
FP64 GEMM (the reference paper's motivating HPC workload).

The PyTorch/CUDA counterpart of ``05_iterative_refinement.py``:

    python examples/torch_05_iterative_refinement.py [--device cuda|cpu] [--n 1024]

Solve A x = b by factorizing in fast low precision (f32, on the host) and
driving the error down with residuals computed in exact emulated f64 on
the int8 engine (``--device``) — each refinement step gains ~p_low digits
until f64-level accuracy.  Without a GPU it stops at once unless
``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import numpy.linalg as la  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    return dev


def main(device="cuda", n=1024) -> dict:
    dev = _device(device)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 2.0 * np.eye(n)  # well-conditioned
    x_true = rng.standard_normal((n, 1))
    b = (A.astype(np.longdouble) @ x_true.astype(np.longdouble)).astype(np.float64)

    # --- low-precision factorization (plain numpy f32 solve, demo-grade) ----
    A32 = A.astype(np.float32)

    def solve_f32(rhs):
        return la.solve(A32, rhs.astype(np.float32)).astype(np.float64)

    x = solve_f32(b)
    errors = [la.norm(x - x_true) / la.norm(x_true)]
    print("it  0: rel f32 solve error:", errors[0])

    for it in range(1, 6):
        # residual in EXACT emulated f64 on the int8 engine — the step that
        # needs true f64 GEMM
        r = b - ozt.matmul(A, x, mode="fp64_int8_9", device=dev)
        x = x + solve_f32(r)
        errors.append(la.norm(x - x_true) / la.norm(x_true))
        print(f"it {it:2d}: rel error: {errors[-1]:.3e}")
        if errors[-1] < 1e-14:
            print("converged to f64 accuracy")
            break
    return dict(A=A, b=b, x_true=x_true, x=x, errors=errors, converged=errors[-1] < 1e-14)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args()
    main(args.device, args.n)
