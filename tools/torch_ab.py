#!/usr/bin/env python3
"""A/B timing of two checkouts of ozimmu_tpu_torch on one CUDA GPU.

    python3 tools/torch_ab.py OLD_ROOT NEW_ROOT [--rounds R] [--solvers] [--ci-test]

Runs the same timing worker from each checkout's root, in the order old,
new, new, old (``R`` times), each turn in a process of its own that builds
that checkout's kernels, so that both versions meet the same card, clocks
and power limit in turns.  Timed with CUDA events after warm-up, at the
shapes the main path and the small-product paths give the recombine
kernel:

  * ``recombine`` (the kernel's wrapper, as ``ops.recombine`` calls it) at
    8192^3 ns=9, 4096^3 ns=9, 1024^3 ns=9 (also the host's time to issue
    one call) and 1025^3 ns=16;
  * ``gemm`` 8192^3 ``fp64_int8_9``, ``gemm`` 1025^3 ``fp64_int8_16`` and
    ``gemm_batched`` 8 x 1024^3 ``fp64_int8_9`` (real), without c and with
    alpha, beta and c as ``chip_smoke.py`` times it, each also as the
    host's time to issue it (``_host_ms``, no wait for the card) and the
    card's busy time in one call (``_device_busy_ms``, ``torch.profiler``);
  * the two products where the eager epilogue takes most of the time:
    ``gemm`` ZGEMM 8192^3 ``fp64_int8_9`` (complex urand01, as
    ``chip_smoke.py`` phase 9), and HPL's first trailing update, 15360^2 x
    1024 ``fp64_int8_9`` with alpha = -1, beta = 1 and c the matrix's own
    strided window (the operands of ``chip_smoke.py`` phase 17), also as
    its peak device memory per output element (allocated during the call,
    over m * n);
  * the peak device memory of ``gemm`` 8192^3 (allocated during the call);
  * with ``--solvers``, ``bench_cli hpl`` at n = 16384 and ``hpl --dtype
    z`` at n = 8192 (block 1024, ``fp64_int8_9``, device panels, after a
    warm-up factorization): the factor seconds and each run's peak device
    memory;
  * with ``--epilogue``, the epilogue and fold as the engine calls them
    at the five cases of PERF.md (8192^2 with alpha = 1, beta = 0 and
    with alpha, beta and c; HPL's 15360^2 update with alpha = -1, beta = 1
    and a strided c; the fold at 8192^2 with alpha = 1 and with complex
    alpha, beta and c), the exponents as that checkout's engine passes
    them (by their parts, or a plane it builds in the call), and the
    epilogue kernel alone on a plane built beforehand (``--epilogue-only``:
    these and nothing else);
  * with ``--ci-test``, the wall time of the bench CLI's 72-case
    ``ci_test`` at 1025 (host-bound: the long-double oracle).

Prints one JSON line per turn and, last, one JSON object with the mean and
the median of each figure per checkout and the ratio of the means, new / old.  Exits non-zero without
a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WORKER = r"""
import contextlib, io, json, subprocess, sys, time, torch
import torch.profiler
import numpy as np
import ozimmu_tpu_torch as ozt
from ozimmu_tpu_torch.bench_cli import run_ci_test
from ozimmu_tpu_torch.ops import recombine_cuda
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

with_ci = "ci" in sys.argv[1:]
with_solvers = "solvers" in sys.argv[1:]
with_epilogue = "epilogue" in sys.argv[1:]
epi_only = "epilogue_only" in sys.argv[1:]
dev = torch.device("cuda")
out = {}
if not epi_only:
    for n, ns, iters in ((8192, 9, 5), (4096, 9, 10), (1024, 9, 50), (1025, 16, 20)):
        b = bits_per_int8(n)
        a = torch.from_numpy(generate_input("urand01", (n, n), seed=0)).to(dev)
        bm = torch.from_numpy(generate_input("urand01", (n, n), seed=1)).to(dev)
        da, _ = split_f64(a, ns, b)
        db, _ = split_f64_cols(bm, ns, b)
        out[f"recombine_{n}_ns{ns}_ms"] = cuda_ms(
            lambda: recombine_cuda.recombine(da, db, ns, b, n), iters)
        if n == 1024:  # the wrapper's host cost per call (the card is slower here)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                recombine_cuda.recombine(da, db, ns, b, n)
            out[f"recombine_{n}_ns{ns}_host_ms"] = (time.perf_counter() - t0) / iters * 1e3
            torch.cuda.synchronize()
        if n in (8192, 1025):
            mode = f"fp64_int8_{ns}"
            out[f"gemm_{n}_{mode}_ms"] = cuda_ms(lambda: ozt.gemm(a, bm, mode=mode), 3 if n == 8192 else 10)
        if n == 8192:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ozt.gemm(a, bm, mode=mode)
            torch.cuda.synchronize()
            out[f"gemm_{n}_{mode}_peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        del a, bm, da, db
    x = torch.from_numpy(generate_input("normal01", (8, 1024, 1024), seed=60)).to(dev)
    y = torch.from_numpy(generate_input("exp_rand-8", (8, 1024, 1024), seed=61)).to(dev)
    c = torch.from_numpy(generate_input("normal01", (8, 1024, 1024), seed=62)).to(dev)
    for tag, kw in (("", {}), ("_with_c", dict(alpha=1.5, beta=-0.5, c=c))):
        batched = lambda: ozt.gemm_batched(x, y, mode="fp64_int8_9", **kw)
        key = f"gemm_batched_8x1024_fp64_int8_9{tag}"
        out[f"{key}_ms"] = cuda_ms(batched, 10)
        # the host's share: the time to issue the calls, without waiting for
        # the card, and the card's busy time (its kernels and copies) in one call
        t0 = time.perf_counter()
        for _ in range(5):
            batched()
        out[f"{key}_host_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            batched()
            torch.cuda.synchronize()
        out[f"{key}_device_busy_ms"] = sum(
            e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    del x, y, c
    a = torch.from_numpy(generate_input("urand01", (8192, 8192), seed=40, complex_=True)).to(dev)
    bm = torch.from_numpy(generate_input("urand01", (8192, 8192), seed=41, complex_=True)).to(dev)
    out["zgemm_8192_fp64_int8_9_ms"] = cuda_ms(lambda: ozt.gemm(a, bm, mode="fp64_int8_9"), 3)
    del a, bm
    import chip_smoke
    ops = chip_smoke.first_step_operands(16384, 1024, False)
    l21, u12, c22 = ops["l21"], ops["u12"], ops["c22"]
    del ops
    update = lambda: ozt.gemm(l21, u12, mode="fp64_int8_9", alpha=-1.0, beta=1.0, c=c22)
    out["hpl_update_15360x15360x1024_ms"] = cuda_ms(update, 3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    update()
    torch.cuda.synchronize()
    out["hpl_update_peak_bytes_per_output_element"] = (
        torch.cuda.max_memory_allocated() - before) / c22.numel()
    del l21, u12, c22
    torch.cuda.empty_cache()

if with_epilogue or epi_only:
    # the epilogue and fold kernels at the shapes of PERF.md's cases: each
    # as the engine calls it (this checkout's core: exponents by their parts
    # where it has Exponents, else the plane it builds first), and the
    # kernel alone on a plane built beforehand where it takes one
    from ozimmu_tpu_torch.core import gemm as core
    from ozimmu_tpu_torch.ops import epilogue_cuda
    from ozimmu_tpu_torch.ops.recombine import acc_shift, recombine
    parts = hasattr(core, "Exponents")
    rng = np.random.default_rng(5)

    def operands(m, k, n, seed):
        a = torch.from_numpy(rng.uniform(-1, 1, (m, k))).to(dev)
        b = torch.from_numpy(rng.uniform(-1, 1, (k, n))).to(dev)
        bk = bits_per_int8(k)
        da, pa = split_f64(a, 9, bk)
        db, pb = split_f64_cols(b, 9, bk)
        return recombine(da, db, 9, bk, k), pa, pb, acc_shift(9, bk)

    def exps(pa, pb, shift):
        return core.Exponents(pa, pb, shift) if parts else core._exponent_plane(pa, pb, shift)

    S, pa, pb, shift = operands(8192, 1024, 8192, 1)
    c = torch.from_numpy(rng.uniform(-1, 1, (8192, 8192))).to(dev)
    plane = core._exponent_plane(pa, pb, shift)
    for key, (al, be, cc) in (("8192_a1_b0", (1.0, 0.0, None)), ("8192_a2_bm05_c", (2.0, -0.5, c))):
        out[f"epilogue_{key}_ms"] = cuda_ms(
            lambda: core._epilogue_SE(S, exps(pa, pb, shift), al, be, cc), 10)
        out[f"epilogue_{key}_on_a_plane_ms"] = cuda_ms(
            lambda: epilogue_cuda.epilogue(S, plane, al, be, cc), 10)
    del S, c, plane
    torch.cuda.empty_cache()
    S, pa, pb, shift = operands(15360, 1024, 15360, 2)
    big = torch.from_numpy(rng.uniform(-1, 1, (16384, 16384))).to(dev)
    c22 = big[1024:, 1024:]
    out["epilogue_hpl_15360_ms"] = cuda_ms(
        lambda: core._epilogue_SE(S, exps(pa, pb, shift), -1.0, 1.0, c22), 5)
    plane = core._exponent_plane(pa, pb, shift)
    out["epilogue_hpl_15360_on_a_plane_ms"] = cuda_ms(
        lambda: epilogue_cuda.epilogue(S, plane, -1.0, 1.0, c22), 5)
    del S, big, c22, plane
    torch.cuda.empty_cache()
    SEs = []
    for i in range(4):
        S, pa, pb, shift = operands(8192, 1024, 8192, 10 + i)
        SEs.append((S, pa, pb, shift))
    cr, ci = (torch.from_numpy(rng.uniform(-1, 1, (8192, 8192))).to(dev) for _ in range(2))
    for key, (al, be, cs) in (("8192_a1", (1.0, 0.0, (None, None))),
                              ("8192_complex_c", (2 - 0.5j, 0.25 + 1j, (cr, ci)))):
        passes = lambda: [(S, exps(pa, pb, shift)) for S, pa, pb, shift in SEs]  # noqa: E731
        out[f"zfold_{key}_ms"] = cuda_ms(
            lambda: core._zfold_passes(passes(), 8192, 8192, al, be, *cs, dev), 5)
    del SEs, cr, ci
    torch.cuda.empty_cache()

if with_solvers:
    from ozimmu_tpu_torch import bench_cli
    for tag, size, extra in (("hpl_16384", 16384, []), ("zhpl_8192", 8192, ["--dtype", "z"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            rc = bench_cli.main(["hpl", "fp64_int8_9", str(size), "--block", "1024", "--warmup",
                                 *extra])
        line = buf.getvalue().strip().splitlines()[-1]
        fields = dict(f.split("=") for f in line.split(",") if "=" in f)
        if rc != 0:
            raise SystemExit(f"bench_cli hpl {size} {extra} failed: {line}")
        out[f"{tag}_factor_s"] = float(fields["factor_time"].rstrip("s"))
        out[f"{tag}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
if with_ci:
    from ozimmu_tpu_torch import oracle
    oracle.lib()  # built before the clock starts
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as rows:
        rc = run_ci_test(sizes=(1025,))
    if rc != 0 or "72 /    72 PASSED" not in rows.getvalue():
        raise SystemExit(f"ci_test at 1025 failed: {rows.getvalue().splitlines()[-1:]}")
    out["ci_test_1025_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def gpu_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def turn(root: str, flags) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", WORKER, *flags], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"worker failed in {root}:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--ci-test", action="store_true", help="also time ci_test at 1025")
    ap.add_argument("--solvers", action="store_true",
                    help="also time HPL n = 16384 and ZHPL n = 8192 through bench_cli hpl")
    ap.add_argument("--epilogue", action="store_true",
                    help="also time the epilogue and fold at PERF.md's five cases")
    ap.add_argument("--epilogue-only", action="store_true",
                    help="time the epilogue and fold cases and nothing else")
    args = ap.parse_args(argv)
    flags = (["ci"] * args.ci_test + ["solvers"] * args.solvers + ["epilogue"] * args.epilogue
             + ["epilogue_only"] * args.epilogue_only)
    import torch

    if not torch.cuda.is_available():
        print("torch_ab: no CUDA GPU", file=sys.stderr)
        return 1
    label = gpu_label()
    print(label, flush=True)
    runs = {"old": [], "new": []}
    for _ in range(args.rounds):
        for which in ("old", "new", "new", "old"):
            got = turn(getattr(args, which), flags)
            runs[which].append(got)
            print(json.dumps({"checkout": which, **got}), flush=True)
    mean = {w: {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]} for w, rs in runs.items()}
    median = {w: {k: statistics.median(r[k] for r in rs) for k in rs[0]} for w, rs in runs.items()}
    ratio = {k: mean["new"][k] / mean["old"][k] for k in mean["new"]}
    print(json.dumps({"gpu": label, "mean_ms": mean, "median_ms": median, "new_over_old": ratio}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
