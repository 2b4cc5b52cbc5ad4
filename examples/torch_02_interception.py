"""Drop-in interception: reroute existing PyTorch f64 matmuls (the
LD_PRELOAD shim equivalent), in your code and in code you do not own.

The PyTorch/CUDA counterpart of ``02_interception.py``:

    python examples/torch_02_interception.py [--device cuda|cpu] [--n 512]

``ozt.intercept.intercept(mode=...)`` is a ``TorchDispatchMode`` over aten
mm / bmm / addmm / baddbmm: every qualifying float64 or complex128 product
inside the block goes through the engine, wherever it is issued.  The JAX
example's ``jax.jit`` line has no counterpart here:
``torch.compile(fullgraph=True)`` refuses to trace under a dispatch mode.
Compiled code calls the engine through ``ozt.traced`` instead
(``torch_06_compiled.py``).  Without a GPU it stops at once unless
``--device cpu`` is given.
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


def main(device="cuda", n=512) -> dict:
    dev = _device(device)
    h = ozt.create(str(dev))
    # reference-compatible thresholds (default 1024; shrink for the demo)
    h.intercept_threshold_m = h.intercept_threshold_n = h.intercept_threshold_k = 256

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(size=(n, n))).to(dev)
    b = torch.from_numpy(rng.uniform(size=(n, n))).to(dev)

    with ozt.intercept.intercept(mode="fp64_int8_9", handle=h):
        c1 = a @ b  # rerouted
        c2 = torch.nn.functional.linear(a, b.T)  # rerouted inside a library function too
        small = a[:64, :64] @ b[:64, :64]  # below threshold: native

    ref = a.cpu().numpy() @ b.cpu().numpy()
    eager = np.linalg.norm(c1.cpu().numpy() - ref) / np.linalg.norm(ref)
    linear = np.linalg.norm(c2.cpu().numpy() - ref) / np.linalg.norm(ref)
    small_native = bool(torch.equal(small, torch.mm(a[:64, :64], b[:64, :64])))
    print("eager residual:", eager)
    print("F.linear residual:", linear)
    print("64^3 product native (bitwise == torch.mm):", small_native)

    # or configure by environment, read per call (reference cublas.cu:18-48):
    #   OZIMMU_COMPUTE_MODE=fp64_int8_9 python my_program.py
    # with ozt.intercept.enable() called once at startup.
    saved = os.environ.get("OZIMMU_COMPUTE_MODE")
    os.environ["OZIMMU_COMPUTE_MODE"] = "fp64_int8_9"
    try:
        ozt.intercept.enable(handle=h)
        try:
            c3 = a @ b  # rerouted: the mode comes from the environment
        finally:
            ozt.intercept.disable()
    finally:
        if saved is None:
            del os.environ["OZIMMU_COMPUTE_MODE"]
        else:
            os.environ["OZIMMU_COMPUTE_MODE"] = saved
    env_residual = np.linalg.norm(c3.cpu().numpy() - ref) / np.linalg.norm(ref)
    print("OZIMMU_COMPUTE_MODE residual:", env_residual)
    return dict(a=a, b=b, c1=c1, c2=c2, c3=c3, small=small, eager_residual=eager,
                linear_residual=linear, env_residual=env_residual, small_native=small_native)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=512)
    args = ap.parse_args()
    main(args.device, args.n)
