#!/usr/bin/env python3
"""The distributed variants on one NCCL rank, two checkouts in turns, on
one CUDA GPU.

    python3 tools/torch_parallel_ab.py OLD_ROOT NEW_ROOT [--rounds R] [--out FILE]

Runs this file's case table (``CASES``) through each checkout's own
``python -m ozimmu_tpu_torch.parallel.local --mesh 1x1 --nproc 1``, from
that checkout's root, in the order old, new, new, old (``R`` times): each
turn a process of its own that builds that checkout's kernels, so that
both versions meet the same card, clocks and power limit in turns.  The
cases use only the public API that both checkouts have, on tensors on the
card, ``fp64_int8_9``:

  * ``sharded_gemm`` with ``variant`` summa, ring and stream at 8192^3;
  * ``sharded_gemm_k`` at 8192^3 on a 1-D mesh of the one rank;
  * ``sharded_gemm_auto(a, b, num_split=9)`` on 2048 x 65536 x 2048 (a
    tall Gram-type product: the chooser says "k");
  * the complex ring at 4096^3;

each as the device time per call (CUDA events, 3 calls after one), beside
the one-device ``gemm`` on the same operands, its peak device memory
(allocated during the call, plus the operands), and whether its bits
equal ``gemm``'s.  Prints one JSON line per turn and, last, one JSON
object with the median of each figure per checkout.  Exits non-zero
without a GPU or if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.abspath(__file__)
NS = 9
N = 8192
TALL = (2048, 65536)
ZN = 4096


def _cuda_ms(fn, iters: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _operands(m: int, k: int, seed: int, cx: bool = False):
    import torch

    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.random(shape)
        return x + 1j * rng.random(shape) if cx else x

    return (torch.from_numpy(draw((m, k))).cuda(), torch.from_numpy(draw((k, m))).cuda())


def _bits(x):
    import torch

    x = torch.view_as_real(x) if x.is_complex() else x
    return x.contiguous().view(torch.int64)


def _case(call, one_device) -> dict:
    import torch

    want = one_device()
    got = call()
    equal = bool(torch.equal(_bits(got), _bits(want)))
    del got, want
    out = {"equal": equal, "ms": _cuda_ms(call), "gemm_ms": _cuda_ms(one_device)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    return out


def _variant(variant: str, n: int = N, cx: bool = False):
    def case(mesh) -> dict:
        import ozimmu_tpu_torch as ozt
        from ozimmu_tpu_torch import parallel as par

        a, b = _operands(n, n, 0, cx)
        return _case(lambda: par.sharded_gemm(a, b, NS, mesh, variant=variant),
                     lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"))
    return case


def _k(mesh) -> dict:
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import parallel as par
    from torch.distributed.device_mesh import init_device_mesh

    kmesh = init_device_mesh("cuda", (1,), mesh_dim_names=("k",))
    a, b = _operands(N, N, 0)
    return _case(lambda: par.sharded_gemm_k(a, b, NS, kmesh),
                 lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"))


def _auto_k(mesh) -> dict:
    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import parallel as par

    m, k = TALL
    a, b = _operands(m, k, 30)
    return _case(lambda: par.sharded_gemm_auto(a, b, num_split=NS, mesh=mesh),
                 lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"))


CASES = {"summa": _variant("summa"), "ring": _variant("ring"), "stream": _variant("stream"),
         "k": _k, "auto_k": _auto_k, "zring": _variant("ring", ZN, cx=True)}


def _turn(root: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="oz_par_ab_") as tmp:
        out = os.path.join(tmp, "r.npz")
        proc = subprocess.run(
            [sys.executable, "-m", "ozimmu_tpu_torch.parallel.local", "--cases",
             f"{HERE}:CASES", "--mesh", "1x1", "--nproc", "1", "--device", "cuda",
             "--timeout", "900", "--out", out],
            cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"turn in {root} failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        res = np.load(out)
        figs = {}
        for key in res.files:
            parts = key.split("/")
            if len(parts) == 3 and parts[2] in ("equal", "ms", "gemm_ms", "peak_gib"):
                figs[f"{parts[1]}/{parts[2]}"] = res[key].item()
            elif len(parts) == 3 and parts[2] == "error":
                raise RuntimeError(f"{root} {parts[1]}: {res[key]}")
        return figs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parallel_ab: needs a CUDA GPU", file=sys.stderr)
        return 1
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    turns = {"old": [], "new": []}
    for _ in range(args.rounds):
        for which in ("old", "new", "new", "old"):
            figs = _turn(roots[which])
            turns[which].append(figs)
            print(json.dumps({"turn": which, "card": label, **figs}), flush=True)
    summary = {"card": label, "roots": roots}
    for which, runs in turns.items():
        summary[which] = {k: statistics.median(float(r[k]) for r in runs) for k in runs[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
