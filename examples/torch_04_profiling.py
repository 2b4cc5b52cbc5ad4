"""Profiling surfaces: phase breakdown, per-call CULiP lines, device traces.

The PyTorch/CUDA counterpart of ``04_profiling.py``:

    python examples/torch_04_profiling.py [--device cuda|cpu] [--n 1024] [--trace-dir DIR]

The trace goes to ``--trace-dir`` (default: a new temporary directory) as
one Chrome-trace JSON file (Perfetto or chrome://tracing), with the CUDA
kernels on a GPU.  Without a GPU it stops at once unless ``--device cpu``
is given.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.utils.profiling import TraceLostError  # noqa: E402

#: traced calls at most (see step 3)
TRACE_ATTEMPTS = 3


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    return dev


def main(device="cuda", n=1024, trace_dir=None) -> dict:
    dev = _device(device)
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(n, n))
    b = rng.uniform(size=(n, n))

    # 1. phase breakdown (the reference's time_breakdown profiler): the engine
    #    runs staged (split / matmul / epilogue timed one by one)
    h = ozt.create(str(dev))
    ozt.enable_profiling(h)
    ozt.gemm(a, b, mode="fp64_int8_9", handle=h)
    ozt.gemm(a, b, mode="fp64_int8_9", handle=h)
    ozt.print_profiler_result(h, tag="demo")  # human-readable
    ozt.print_profiler_result(h, tag="demo", csv=True)  # CSV rows
    ozt.disable_profiling(h)
    phases = {name: count for name, count, _, _ in h.profiler.result_rows()}

    # 2. per-call wall-clock lines (reference CULiP):
    #    OZIMMU_ENABLE_CULIP_PROFILING=1 prints one line per intercepted call

    # 3. deep kernel timeline -> Perfetto / chrome://tracing
    #    (torch.profiler on a GPU now and then keeps none of a trace's
    #    kernels; device_trace raises TraceLostError then, and the call is
    #    traced again, at most TRACE_ATTEMPTS times in all)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="ozimmu_trace_")
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        try:
            with ozt.device_trace(trace_dir):
                c = ozt.matmul(a, b, mode="fp64_int8_9", device=dev)
            break
        except TraceLostError as e:
            if attempt == TRACE_ATTEMPTS:
                raise
            print(f"{e}; tracing the call again")
    print("trace written to", trace_dir)
    return dict(a=a, b=b, c=c, phases=phases, trace_dir=trace_dir,
                trace_files=sorted(os.listdir(trace_dir)), trace_attempts=attempt)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    main(args.device, args.n, args.trace_dir)
