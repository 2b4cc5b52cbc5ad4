#!/usr/bin/env python3
"""Whether torch.profiler's device timestamps drift from the host's over a
process's life, on one CUDA GPU.

    python3 tools/torch_trace_drift.py [--seconds 540] [--every 15]

Every ``--every`` seconds (the card and host kept busy in between with
float64 and engine GEMMs), traces one short engine call (``matmul``
1024^3 ``fp64_int8_9`` on numpy operands) with ``torch.profiler`` as it
is, without the pads of ``utils.profiling.device_trace``, and prints one
line: the process's age, the device kernels the trace kept, the kernel
launches it saw, and kernel start - launch (us) over the pairs joined by
their correlation id.  A kernel starts a few microseconds after its
launch; a negative or growing figure is the device clock drifting from the
host's, and a trace that keeps fewer kernels than it saw launches dropped
the rest as outside its host-clock window.  The card's name and power
limit come first.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=540.0)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_drift: no CUDA GPU", file=sys.stderr)
        return 1
    import ozimmu_tpu_torch as ozt
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(1024, 1024)), rng.uniform(size=(1024, 1024))
    big = torch.rand(8192, 8192, dtype=torch.float64, device="cuda")
    ozt.matmul(a, b, mode="fp64_int8_9", device="cuda")
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ozt.matmul(a, b, mode="fp64_int8_9", device="cuda")
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")}
        kernels = [(e["args"].get("correlation"), float(e["ts"])) for e in events
                   if e.get("cat") == "kernel"]
        delta = [ts - launch[c] for c, ts in kernels if c in launch]
        print(f"t={time.time() - t0:.1f}s kernels={len(kernels)} launches={len(launch)} "
              f"kernel-launch us: median={statistics.median(delta) if delta else float('nan'):.1f} "
              f"min={min(delta) if delta else float('nan'):.1f}", flush=True)
        t1 = time.time()
        while time.time() - t1 < args.every:
            torch.matmul(big, big)
            ozt.gemm(big[:2048, :2048], big[:2048, :2048], mode="fp64_int8_9")
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
