#!/usr/bin/env python3
"""Smoke run of ozimmu_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ozimmu_tpu_torch/csrc``, checks each kernel
bit for bit against its plain PyTorch version, drives the main path — the
real DGEMM ``gemm(a, b, mode="fp64_int8_9")`` at m = n = k = 8192 — checks
its bits against the plain pipeline and its residual against a long-double
oracle, shows that the main path went through both kernels, and times the
main path, its phases, each kernel against its plain version, and
``torch.matmul`` on float64.

Any failed phase raises, and the script exits non-zero without printing a
result.  It needs a CUDA GPU: without one it exits non-zero at once.  The
last line of its output is a JSON object naming the device; the line
before it is a JSON object with one entry per kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 8192  # main-path size: m = n = k
NS = 9  # fp64_int8_9
RESIDUAL_GATE = 1e-15


def gpu_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def special_matrix() -> np.ndarray:
    """Zero row and column, subnormals, -0.0 and extreme magnitudes."""
    x = np.random.default_rng(3).standard_normal((64, 128))
    x[0, :] = 0.0
    x[:, 0] = 0.0
    x[1, 1] = 5e-324
    x[2, 2] = -1e-310
    x[3, 3] = -0.0
    x[4, 4] = 1e300
    x[5, 5] = -1e-300
    return x


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    view = {torch.float64: torch.int64, torch.float32: torch.int32}.get(x.dtype, x.dtype)
    return x.shape == y.shape and torch.equal(x.view(view), y.view(view))


def residual(got: np.ndarray, ref: np.ndarray) -> dict:
    from ozimmu_tpu_torch.testing import error_metrics

    r = error_metrics(got, None, None, c_ref=ref)
    if not r["relative_residual"] < RESIDUAL_GATE:
        raise AssertionError(f"relative residual {r['relative_residual']:.3e} >= {RESIDUAL_GATE}")
    return r


def block(rng, m: int, n: int):
    """A sampled (64 rows x 256 columns) block of an m x n output."""
    rows = np.sort(rng.choice(m, size=min(64, m), replace=False))
    cols = np.sort(rng.choice(n, size=min(256, n), replace=False))
    return rows, cols


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 1

    import ozimmu_tpu_torch as ozt
    from ozimmu_tpu_torch import native
    from ozimmu_tpu_torch.ops import recombine_cuda, split_cuda
    from ozimmu_tpu_torch.ops.pack import pack_f64
    from ozimmu_tpu_torch.ops.recombine import (
        acc_shift, fold_group_totals, group_totals, recombine,
    )
    from ozimmu_tpu_torch.ops.split import (
        row_exponent, split_f64, split_f64_cols, split_with_row_exp,
    )
    from ozimmu_tpu_torch.schedule import bits_per_int8, group_schedule
    from ozimmu_tpu_torch.testing import generate_input, reference_gemm

    dev = torch.device("cuda")

    # 1. the device
    label = gpu_label()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(label, flush=True)

    # 2. build the kernels from the sources in the checkout
    t0 = time.perf_counter()
    native.lib()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({native.library_path()})", flush=True)
    for line in native.build_log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    max_err = {"split_digits": 0.0, "recombine": 0.0}

    # 3. split: kernel vs plain, bitwise
    mats = {
        "normal01(1000x1234)": generate_input("normal01", (1000, 1234), seed=1),
        "exp_rand-8(1000x1234)": generate_input("exp_rand-8", (1000, 1234), seed=2),
        "special(64x128)": special_matrix(),
    }
    n_cases = 0
    for name, x_np in mats.items():
        x = torch.from_numpy(x_np).to(dev)
        for axis in (0, 1):
            e = row_exponent(x, axis)
            for ns in (3, 9, 18):
                for b in (7, 5):
                    want, _ = split_with_row_exp(x, e, ns, b, axis)
                    got = split_cuda.split_digits(x, e, ns, b, axis)
                    err = (want.to(torch.int16) - got.to(torch.int16)).abs().max().item()
                    max_err["split_digits"] = max(max_err["split_digits"], float(err))
                    if not bits_equal(want, got):
                        raise AssertionError(f"split mismatch: {name} axis={axis} ns={ns} b={b}")
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"[split] kernel == plain bitwise in {n_cases} cases", flush=True)

    # 4. recombine: kernel vs plain, bitwise on all three f32 planes
    for (m, n, k), ns in (((200, 136, 272), 6), ((256, 128, 1024), 8),
                          ((1000, 1234, 777), 9), ((64, 64, 16384), 9)):
        b = bits_per_int8(k)
        a_t = torch.from_numpy(generate_input("normal01", (m, k), seed=m)).to(dev)
        b_t = torch.from_numpy(generate_input("exp_rand-8", (k, n), seed=n)).to(dev)
        da, _ = split_f64(a_t, ns, b)
        db, _ = split_f64_cols(b_t, ns, b)
        want = fold_group_totals(group_totals(da, db, ns, k, b), ns, k, b)
        got = recombine_cuda.recombine(da, db, ns, b, k)
        err = max((w - g).abs().max().item() for w, g in zip(want, got))
        max_err["recombine"] = max(max_err["recombine"], float(err))
        if not all(bits_equal(w, g) for w, g in zip(want, got)):
            raise AssertionError(f"recombine mismatch at m,n,k={m},{n},{k} ns={ns}")
        groups = group_schedule(ns, k, b)
        print(f"[recombine] kernel == plain bitwise (3 planes) at m,n,k={m},{n},{k} ns={ns} "
              f"b={b}: {len(groups)} groups of {[len(g.pairs) for g in groups]} pairs", flush=True)

    # 5. the main path at full size
    rng = np.random.default_rng(0)
    a_np = generate_input("urand01", (N, N), seed=0)
    b_np = generate_input("urand01", (N, N), seed=1)
    a = torch.from_numpy(a_np).to(dev)
    b = torch.from_numpy(b_np).to(dev)
    torch.cuda.synchronize()
    split_cuda.LAUNCHES = 0
    recombine_cuda.LAUNCHES = 0
    out = ozt.gemm(a, b, mode=f"fp64_int8_{NS}")
    torch.cuda.synchronize()
    launches = {"split_digits": split_cuda.LAUNCHES, "recombine": recombine_cuda.LAUNCHES}

    bb = bits_per_int8(N)
    pda, ppa = split_with_row_exp(a, row_exponent(a, 1), NS, bb, 1)
    pdb, ppb = split_with_row_exp(b, row_exponent(b, 0), NS, bb, 0)
    S = fold_group_totals(group_totals(pda, pdb, NS, N, bb), NS, N, bb)
    E = (ppa[:, None] + ppb[None, :] - acc_shift(NS, bb)).to(torch.int32)
    plain_out = pack_f64(S, E)
    if not bits_equal(out, plain_out):
        raise AssertionError("main path output differs from the plain pipeline")
    del pda, pdb, S, E, plain_out
    rows, cols = block(rng, N, N)
    ref = reference_gemm(a_np[rows], b_np[:, cols])
    r = residual(out[rows][:, cols].cpu().numpy(), ref)
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite values in the main-path output")
    print(f"[main] gemm fp64_int8_{NS} {N}^3 on {dev}: bits == plain pipeline; sampled 64x256 "
          f"block relative_residual={r['relative_residual']:.3e} "
          f"max_relative_error={r['max_relative_error']:.3e}", flush=True)

    # probes at modest sizes, each under the same residual gate
    m, n, k = 1000, 1234, 777
    at_np = generate_input("normal01", (k, m), seed=11)  # op_a="T" reads it as [m, k]
    bt_np = generate_input("normal01", (k, n), seed=12)
    ct_np = generate_input("normal01", (m, n), seed=13)
    got = ozt.gemm(at_np, bt_np, mode=f"fp64_int8_{NS}", op_a="T", alpha=2.0, beta=-0.5,
                   c=ct_np, device=dev)
    rows, cols = block(rng, m, n)
    ref = 2.0 * reference_gemm(at_np.T[rows], bt_np[:, cols]) - 0.5 * ct_np[rows][:, cols].astype(np.longdouble)
    r = residual(got[rows][:, cols], ref)
    print(f"[probe] {m}x{n}x{k} op_a=T alpha=2 beta=-0.5: "
          f"relative_residual={r['relative_residual']:.3e}", flush=True)

    x_np = generate_input("exp_rand-8", (1024, 1024), seed=21)
    y_np = generate_input("exp_rand-8", (1024, 1024), seed=22)
    got = ozt.gemm(x_np, y_np, mode="fp64_int8_18", device=dev)
    r = residual(got, reference_gemm(x_np, y_np))
    print(f"[probe] 1024^3 fp64_int8_18 exp_rand-8: relative_residual={r['relative_residual']:.3e}",
          flush=True)

    xa = torch.from_numpy(at_np.T.copy()).to(dev)
    xb = torch.from_numpy(bt_np).to(dev)
    one = ozt.gemm_f64(xa, xb, NS, n_chunks=1)
    three = ozt.gemm_f64(xa, xb, NS, n_chunks=3)
    if not bits_equal(one, three):
        raise AssertionError("n_chunks=3 differs from n_chunks=1")
    r = residual(three[rows][:, cols].cpu().numpy(), reference_gemm(at_np.T[rows], bt_np[:, cols]))
    print(f"[probe] {m}x{n}x{k} n_chunks=3 == n_chunks=1 bitwise; "
          f"relative_residual={r['relative_residual']:.3e}", flush=True)

    # 6. the main path went through both kernels
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was not launched: {launches}")
    print(f"[launches] main path {N}^3: {launches}", flush=True)

    # 7. timing (CUDA events, after warm-up); nothing is asserted on speed
    ms_main = cuda_ms(lambda: ozt.gemm(a, b, mode=f"fp64_int8_{NS}"), iters=3)
    print(f"[time] {label}: gemm fp64_int8_{NS} {N}^3: {ms_main:.3f} ms, "
          f"{2 * N**3 / ms_main / 1e9:.3f} effective FP64 TFLOPS", flush=True)

    phases = {}
    phases["split_A"] = cuda_ms(lambda: split_f64(a, NS, bb), iters=5)
    phases["split_B"] = cuda_ms(lambda: split_f64_cols(b, NS, bb), iters=5)
    da, pa = split_f64(a, NS, bb)
    db, pb = split_f64_cols(b, NS, bb)
    phases["recombine"] = cuda_ms(lambda: recombine(da, db, NS, bb, N), iters=3)
    S = recombine(da, db, NS, bb, N)
    phases["epilogue"] = cuda_ms(
        lambda: pack_f64(S, (pa[:, None] + pb[None, :] - acc_shift(NS, bb)).to(torch.int32)),
        iters=5)
    del S
    print(f"[time] {label}: phases of {N}^3 fp64_int8_{NS}: "
          + ", ".join(f"{k_} {v:.3f} ms" for k_, v in phases.items())
          + f" (sum {sum(phases.values()):.3f} ms)", flush=True)

    e_a = row_exponent(a, 1)
    ms = {
        "split_digits": cuda_ms(lambda: split_cuda.split_digits(a, e_a, NS, bb, 1), iters=5),
        "recombine": cuda_ms(lambda: recombine_cuda.recombine(da, db, NS, bb, N), iters=3),
    }
    plain_ms = {
        "split_digits": cuda_ms(lambda: split_with_row_exp(a, e_a, NS, bb, 1), iters=3),
        "recombine": cuda_ms(
            lambda: fold_group_totals(group_totals(da, db, NS, N, bb), NS, N, bb), iters=3),
    }
    for name in ms:
        print(f"[time] {label}: {name} at the main-path shape: kernel {ms[name]:.3f} ms, "
              f"plain PyTorch {plain_ms[name]:.3f} ms", flush=True)
    del da, db

    ms_dgemm = cuda_ms(lambda: torch.matmul(a, b), iters=3)
    print(f"[time] {label}: torch.matmul float64 {N}^3: {ms_dgemm:.3f} ms, "
          f"{2 * N**3 / ms_dgemm / 1e9:.3f} TFLOPS", flush=True)

    kernels = [
        {"name": "split_digits", "route": "cuda", "source": "ozimmu_tpu_torch/csrc/split.cu",
         "replaces": "ozimmu_tpu/ops/split_pallas.py:134"},
        {"name": "recombine", "route": "cuda", "source": "ozimmu_tpu_torch/csrc/recombine.cu",
         "replaces": "ozimmu_tpu/ops/recombine_pallas.py:182"},
    ]
    for kern in kernels:
        name = kern["name"]
        kern.update(launches=launches[name], max_abs_err=max_err[name],
                    ms=ms[name], plain_ms=plain_ms[name])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
