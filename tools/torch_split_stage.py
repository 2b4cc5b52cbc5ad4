#!/usr/bin/env python3
"""The split stage of ozimmu_tpu_torch on one CUDA GPU, timed, against the
parent's layout.

    python3 tools/torch_split_stage.py [--parent ROOT] [--rounds R]

In this checkout: the exponent-max and split kernels against their plain
versions, bitwise, on a few shapes (both plane layouts, a batch, a strided
column panel, k off the multiple of 16), then, with CUDA events after
warm-up, at 8192^2 ns = 9 (``fp64_int8_9``), 8 x 1024^3 and 64 x 256^3:

  * each kernel beside its bound (bytes over 3.35 TB/s) and its plain
    version: ``row_exponent`` by rows (A) and by columns (B), the split of
    A and of B in the natural layout and k-major;
  * each operand's split stage as the engine runs it (exponent + split);
  * the parent layout's transposed copy of B's planes ([ns, k, n] ->
    [ns, n, k_pad], what the recombine wrapper copied before) on its own,
    and recombine with and without it.

Then, in turns with the checkout at ``--parent`` (parent, this, this,
parent, ``R`` times; each turn a process of its own that builds that
checkout's kernels): each operand's split stage as that checkout's engine
runs it, recombine as its engine calls it, ``gemm`` and ``gemm`` ZGEMM at
8192^3 ``fp64_int8_9`` and the GEMM's peak device memory.  Prints one JSON
line per figure set and the card's name and power limit; exits non-zero
without a GPU or if a kernel differs from its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import inspect, json, torch
import ozimmu_tpu_torch as ozt
from ozimmu_tpu_torch.ops.recombine import recombine
from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters

N, NS = 8192, 9
bb = bits_per_int8(N)
kmajor = "k_pad" in inspect.signature(split_f64).parameters
kw = {"k_pad": N} if kmajor else {}
a = torch.from_numpy(generate_input("urand01", (N, N), seed=0)).cuda()
b = torch.from_numpy(generate_input("urand01", (N, N), seed=1)).cuda()
out = {"kmajor": kmajor}
out["split_A_stage_ms"] = cuda_ms(lambda: split_f64(a, NS, bb, **kw), 10)
out["split_B_stage_ms"] = cuda_ms(lambda: split_f64_cols(b, NS, bb, **kw), 10)
da, db = split_f64(a, NS, bb, **kw)[0], split_f64_cols(b, NS, bb, **kw)[0]
rkw = {"b_kmajor": True} if kmajor else {}
out["recombine_ms"] = cuda_ms(lambda: recombine(da, db, NS, bb, N, **rkw), 5)
del da, db
mode = f"fp64_int8_{NS}"
out["gemm_ms"] = cuda_ms(lambda: ozt.gemm(a, b, mode=mode), 5)
torch.cuda.synchronize()
torch.cuda.empty_cache()
before = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
ozt.gemm(a, b, mode=mode)
torch.cuda.synchronize()
out["gemm_peak_GiB"] = (torch.cuda.max_memory_allocated() - before) / 2**30
az = torch.complex(a, b)
bz = torch.complex(b, a)
del a, b
out["zgemm_ms"] = cuda_ms(lambda: ozt.gemm(az, bz, mode=mode), 3)
print(json.dumps(out), flush=True)
"""

HBM_BYTES_PER_S = 3.35e12


def label() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def kernels_here() -> dict:
    """Bitwise checks and kernel times in this checkout."""
    import torch

    from ozimmu_tpu_torch import native
    from ozimmu_tpu_torch.ops import exponent_cuda, recombine_cuda, split_cuda
    from ozimmu_tpu_torch.ops.recombine import padded_k, recombine
    from ozimmu_tpu_torch.ops.split import row_exponent_plain, split_f64, split_f64_cols
    from ozimmu_tpu_torch.ops.split import split_with_row_exp
    from ozimmu_tpu_torch.schedule import bits_per_int8
    from ozimmu_tpu_torch.testing import generate_input

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import cuda_ms

    native.lib()
    entry = "?"
    for line in native.build_log.splitlines():  # ptxas: registers and spills of each kernel
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("Used" in line or "spill" in line) and ("split" in entry or "exponent" in entry):
            print(f"[build] {entry}: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    cases = 0
    for shape, name, view in (((1000, 1234), "normal01", None), ((777, 1001), "exp_rand-8", None),
                              ((3, 300, 17), "exp_rand-8", None), ((1, 15), "normal01", None),
                              ((16, 16), "normal01", None), ((64, 777), "exp_rand-8", None),
                              ((1000, 1234), "exp_rand-8", (3, 700)),
                              ((1000, 1234), "normal01", (4, 701)),
                              ((4, 256, 130), "normal01", None)):
        x = torch.from_numpy(generate_input(name, shape, seed=cases)).to(dev)
        if view is not None:
            x = x[:, view[0]:view[1]]
        for axis in (0, 1):
            e = row_exponent_plain(x, axis)
            if not torch.equal(exponent_cuda.exponent_max(x, axis), e):
                raise AssertionError(f"exponent kernel != plain: {tuple(x.shape)} axis {axis}")
            k = x.shape[-1] if axis == 1 else x.shape[-2]
            for ns, b in ((3, 7), (9, 5), (18, 7)):
                for kp in (None, padded_k(k), padded_k(k) + 16):
                    want, _ = split_with_row_exp(x, e, ns, b, axis, kp)
                    got = split_cuda.split_digits(x, e, ns, b, axis, kp)
                    if not torch.equal(want, got):
                        raise AssertionError(f"split kernel != plain: {tuple(x.shape)} {x.stride()} "
                                             f"axis {axis} ns {ns} b {b} k_pad {kp}")
                    cases += 1
    print(json.dumps({"bitwise_cases": cases}), flush=True)

    res = {}
    for tag, shape in (("8192^2", (8192, 8192)), ("8x1024^2", (8, 1024, 1024)),
                       ("64x256^2", (64, 256, 256))):
        ns = 9
        k = shape[-1]
        bb = bits_per_int8(k)
        x = torch.from_numpy(generate_input("urand01", shape, seed=5)).to(dev)
        el = x.numel()
        r = {}
        for axis, op in ((1, "A"), (0, "B")):
            e = exponent_cuda.exponent_max(x, axis)
            r[f"exponent_{op}"] = (cuda_ms(lambda: exponent_cuda.exponent_max(x, axis), 20),
                                   cuda_ms(lambda: row_exponent_plain(x, axis), 5),
                                   (8 * el + 4 * el // k) / HBM_BYTES_PER_S * 1e3)
            for kp, lay in ((None, "natural"), (padded_k(k), "kmajor")):
                r[f"split_{op}_{lay}"] = (
                    cuda_ms(lambda: split_cuda.split_digits(x, e, ns, bb, axis, kp), 20),
                    cuda_ms(lambda: split_with_row_exp(x, e, ns, bb, axis, kp), 3),
                    ((8 + ns) * el + 4 * (el // k)) / HBM_BYTES_PER_S * 1e3)
            stage = split_f64 if axis == 1 else split_f64_cols
            r[f"stage_{op}"] = (cuda_ms(lambda: stage(x, ns, bb, padded_k(k)), 20), None,
                                (8 + ns) * el / HBM_BYTES_PER_S * 1e3)
        # the parent layout: B's natural planes copied k-major, then recombine
        db_nat = split_cuda.split_digits(x, exponent_cuda.exponent_max(x, 0), ns, bb, 0)
        dbt = db_nat.transpose(-1, -2)
        copy = lambda: recombine_cuda._pad_k_major(dbt, padded_k(k))  # noqa: E731
        r["transposed_copy"] = (cuda_ms(copy, 20), None, 2 * ns * el / HBM_BYTES_PER_S * 1e3)
        da, _ = split_f64(x, ns, bb, padded_k(k))
        db, _ = split_f64_cols(x, ns, bb, padded_k(k))
        if not all(torch.equal(w.view(torch.int32), g.view(torch.int32)) for w, g in zip(
                recombine(da, db, ns, bb, k, b_kmajor=True),
                recombine_cuda.recombine(split_f64(x, ns, bb)[0], db_nat, ns, bb, k))):
            raise AssertionError(f"recombine on k-major B != on [ns, k, n] B at {tag}")
        r["recombine_kmajor"] = (cuda_ms(lambda: recombine(da, db, ns, bb, k, b_kmajor=True), 5),
                                 None, None)
        dan = split_f64(x, ns, bb)[0]
        r["recombine_with_copy"] = (cuda_ms(lambda: recombine_cuda.recombine(dan, db_nat, ns, bb, k),
                                            5), None, None)
        res[tag] = {name: [None if v is None else round(v, 4) for v in t] for name, t in r.items()}
        del x, da, db, dan, db_nat, dbt
        torch.cuda.empty_cache()
    print(json.dumps({"kernels (ms, plain ms, bound ms)": res}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_split_stage: needs a CUDA GPU", file=sys.stderr)
        return 1
    print(label(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    kernels_here()
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    roots = {"this": here, "parent": os.path.abspath(args.parent) if args.parent else None}
    for _ in range(args.rounds):
        for who in order:
            proc = subprocess.run([sys.executable, "-c", TURN], cwd=roots[who],
                                  capture_output=True, text=True,
                                  env={**os.environ, "PYTHONPATH": roots[who]})
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            print(json.dumps({"turn": who, **json.loads(proc.stdout.strip().splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
