#!/usr/bin/env python3
"""The plain (eager PyTorch) epilogue and complex fold of ozimmu_tpu_torch,
op by op, on one CUDA GPU.

    python3 tools/torch_epilogue_profile.py [--out FILE]

Runs ``core.gemm._epilogue_block`` and ``core.gemm._zfold_block`` (the
plain versions, never the CUDA kernel) under ``torch.profiler`` at the
shapes the engine gives them:

  * 8192^2, alpha = 1, beta = 0 (the ``fp64_int8_9`` main path: the pack
    alone) and alpha = 2, beta = -0.5 with c (the scaled path);
  * HPL's first trailing update, 15360^2 with alpha = -1, beta = 1 and c
    the strided window ``a[1024:, 1024:]`` of a 16384^2 matrix;
  * the complex fold at 8192^2, alpha = 1, beta = 0 (ZGEMM's main path)
    and with complex alpha, beta and c.

The inputs are exact triples of random float64 values (``unpack_f64``),
made from a seed; the plain code has no branch on the data.  For each case
it prints one JSON line: the CUDA-event time of one call after warm-up,
the device kernels of one traced call and their summed device time, the
device time and kernel count by torch op (the op that launched the
kernel), and the peak device memory the call allocated over the output's
elements.  The card's name and power limit come first.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gpu_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def triple(rng, m: int, n: int, dev):
    """(S, E) of random float64 values, exact: value == sum(S) * 2^E."""
    from ozimmu_tpu_torch.ops.pack import unpack_f64

    x = torch.from_numpy(rng.standard_normal((m, n))).to(dev)
    return unpack_f64(x)


def by_op(prof) -> dict:
    """(device ms, device kernels, {op: ms and kernels}) of one traced
    call: the profiler attaches each device kernel to the host event that
    launched it, and the kernel is charged to the innermost ``aten::`` op
    around that event."""
    per = collections.defaultdict(lambda: [0.0, 0])
    total, n = 0.0, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        op = e
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        name = op.name if op is not None else e.name
        for k in e.kernels:
            per[name][0] += k.duration / 1e3
            per[name][1] += 1
            total += k.duration / 1e3
            n += 1
    top = sorted(per.items(), key=lambda kv: -kv[1][0])
    return total, n, {k: {"ms": round(v[0], 4), "kernels": v[1]} for k, v in top}


def profile(what: str, fn, elements: int) -> dict:
    ms = cuda_ms(fn)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    total, n, ops = by_op(prof)
    return {"case": what, "ms": ms, "device_kernels": n, "device_ms": total,
            "peak_bytes": peak, "peak_bytes_per_element": peak / elements, "by_op": ops}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_epilogue_profile: no CUDA GPU", file=sys.stderr)
        return 1
    from ozimmu_tpu_torch.core.gemm import _epilogue_block, _zfold_block

    label = gpu_label()
    print(label, flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lines = []
    n = 8192
    S, E = triple(rng, n, n, dev)
    c = torch.from_numpy(rng.standard_normal((n, n))).to(dev)
    lines.append(profile(f"epilogue {n}^2 alpha=1 beta=0",
                         lambda: _epilogue_block(S, E, 1.0, 0.0, None), n * n))
    lines.append(profile(f"epilogue {n}^2 alpha=2 beta=-0.5 c",
                         lambda: _epilogue_block(S, E, 2.0, -0.5, c), n * n))
    del S, E, c
    torch.cuda.empty_cache()

    big, blk = 16384, 1024
    m = big - blk
    S, E = triple(rng, m, m, dev)
    a = torch.from_numpy(rng.standard_normal((big, big))).to(dev)
    window = a[blk:, blk:]
    lines.append(profile(f"epilogue {m}^2 alpha=-1 beta=1 c strided window of {big}^2",
                         lambda: _epilogue_block(S, E, -1.0, 1.0, window), m * m))
    del S, E, a, window
    torch.cuda.empty_cache()

    SEs = [triple(rng, n, n, dev) for _ in range(4)]
    c_re, c_im = (torch.from_numpy(rng.standard_normal((n, n))).to(dev) for _ in range(2))
    lines.append(profile(f"zfold {n}^2 alpha=1 beta=0",
                         lambda: _zfold_block(SEs, n, n, 1 + 0j, 0j, None, None, dev), n * n))
    lines.append(profile(f"zfold {n}^2 alpha=2-0.5j beta=0.25+1j c",
                         lambda: _zfold_block(SEs, n, n, 2 - 0.5j, 0.25 + 1j, c_re, c_im, dev),
                         n * n))
    for line in lines:
        print(json.dumps({"gpu": label, **line}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps({"gpu": label, **line}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
