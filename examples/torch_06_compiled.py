"""The compiled-code API: engine calls inside YOUR ``torch.compile`` d code.

The PyTorch/CUDA counterpart of ``06_traced_in_jit.py``:

    python examples/torch_06_compiled.py [--device cuda|cpu] [--n 256]

No global interception, no host round-trips — ``ozt.traced.gemm`` is a
custom op that ``torch.compile(fullgraph=True)`` traces like any other
torch op.  The compiled call is bit-identical to the host API on the GPU
and on the CPU alike (the JAX package's is on the CPU only).  Without a
GPU it stops at once unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch import traced  # noqa: E402


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    return dev


def main(device="cuda", n=256) -> dict:
    dev = _device(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(n, n))).to(dev)
    b = torch.from_numpy(rng.normal(size=(n, n))).to(dev)
    c = torch.from_numpy(rng.normal(size=(n, n))).to(dev)

    @torch.compile(fullgraph=True)
    def power_step(a, b, c):
        """A composite compiled computation with two engine calls inside."""
        g = traced.gemm(a, b, alpha=2.0, beta=1.0, c=c, num_split=9)
        return traced.matmul(g, b), torch.trace(g)

    g2, tr = power_step(a, b, c)
    an, bn, cn = (x.cpu().numpy() for x in (a, b, c))
    ref_g = 2.0 * (an @ bn) + cn
    ref = ref_g @ bn
    residual = np.linalg.norm(g2.cpu().numpy() - ref) / np.linalg.norm(ref)
    trace_ok = bool(np.isclose(float(tr), np.trace(ref_g)))
    print("residual:", residual)
    print("trace matches:", trace_ok)

    # the compiled path is bit-identical to the host API, on either device
    host = ozt.gemm(a, b, mode="fp64_int8_9", alpha=2.0, beta=1.0, c=c)
    compiled = torch.compile(lambda x, y, z: traced.gemm(x, y, alpha=2.0, beta=1.0, c=z),
                             fullgraph=True)(a, b, c)
    bitwise = bool(torch.equal(compiled.view(torch.int64), host.view(torch.int64)))
    print("bitwise == host API:", bitwise)

    # batched: each matrix with its own scales
    ab = torch.stack([a, 2 * a])
    bb = torch.stack([b, b])
    out = traced.gemm_batched(ab, bb)
    print("batched ok:", tuple(out.shape))
    return dict(a=a, b=b, c=c, g2=g2, trace=tr, residual=residual, trace_ok=trace_ok,
                compiled=compiled, host=host, bitwise=bitwise, batched=out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args()
    main(args.device, args.n)
