#!/usr/bin/env python3
"""Headline benchmark of ozimmu_tpu_torch: effective FP64 TFLOPS of the
emulated DGEMM on one CUDA GPU (the port of ``bench.py``).

    python3 bench_torch.py

Prints ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": "TFLOPS", "vs_baseline": R}

``value`` is 2·M³ / t / 1e12 for ``gemm(a, b, mode="fp64_int8_<NS>")`` at
m = n = k = M, where t is the median over the repeats of one call's mean
time in a run of ITERS back-to-back calls (CUDA events, after one warm
call).  ``vs_baseline`` is ``value`` over the TFLOPS of ``torch.matmul`` on
float64 (the card's own FP64 GEMM) on the same operands, timed the same way
in the same run; it is null with ``OZ_BENCH_SKIP_NATIVE=1`` or when the
baseline fails (its cause goes to stderr).  A failure of the engine exits
1.  Everything else goes to stderr: the accuracy at 1024^3 and the
headline product's own residual on a sampled 256 x 256 block (both against
the long-double oracle), each repeat's ms, their median and range, the
peak allocated memory, and the card's name, power limit, SM clock and
power draw before each timed window, in each repeat and after it.

Knobs (those of ``bench.py``): ``OZ_BENCH_M`` (16384), ``OZ_BENCH_NS`` (9),
``OZ_BENCH_ITERS`` (4 at M >= 16384, else 6), ``OZ_BENCH_SKIP_NATIVE=1``.
Operands are float64 uniform in [0, 1): above M = 8192 made on the card
(a ``torch.Generator`` seeded 0 for A and 1 for B), else from numpy's
``default_rng(0)`` after the accuracy check's operands, placed once.

Without a CUDA GPU it prints the reason to stderr and exits 1: it does not
run on the CPU.  ``run(..., device="cpu")`` does, for tests.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import traceback

import numpy as np
import torch

from ozimmu_tpu_torch import oracle
from ozimmu_tpu_torch.bench_cli import sampled_block
from ozimmu_tpu_torch.core.api import gemm
from ozimmu_tpu_torch.testing import _timed_calls
from ozimmu_tpu_torch.utils.profiling import synchronize

REPEATS = 5
ACC_SIZE = 1024
#: above this size the operands are made on the card (bench.py's device_gen)
HOST_OPERANDS_MAX_M = 8192
SMI_QUERY = "name,power.limit,clocks.sm,power.draw"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def knobs(env=os.environ) -> dict:
    """The benchmark's settings from ``bench.py``'s environment variables."""
    m = int(env.get("OZ_BENCH_M", 16384))
    return {"m": m, "ns": int(env.get("OZ_BENCH_NS", 9)),
            "iters": int(env.get("OZ_BENCH_ITERS", 4 if m >= 16384 else 6)),
            "skip_native": env.get("OZ_BENCH_SKIP_NATIVE") == "1"}


def metric(m: int, ns: int) -> str:
    return f"fp64_int8_{ns} effective FP64 TFLOPS (m=n=k={m})"


def smi(dev: torch.device):
    """A running ``nvidia-smi`` query of the card (name, power limit, SM
    clock, power draw), or None off the card; :func:`smi_read` reads it."""
    if dev.type != "cuda":
        return None
    return subprocess.Popen(["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def smi_read(proc) -> str:
    if proc is None:
        return "not measured (no CUDA device)"
    out, _ = proc.communicate(timeout=60)
    return out.strip().splitlines()[0] if out.strip() else f"nvidia-smi exit {proc.returncode}"


def accuracy_check(ns: int, size: int, device, rng: np.random.Generator):
    """``bench.py``'s accuracy check: ``gemm`` of two uniform size x size
    operands drawn from ``rng`` (A, then B), scored against the
    long-double oracle.  Returns the product and its metrics."""
    am = rng.uniform(size=(size, size))
    bm = rng.uniform(size=(size, size))
    c = gemm(am, bm, mode=f"fp64_int8_{ns}", device=device)
    return c, oracle.error_metrics(c, am, bm)


def operands(m: int, dev: torch.device, rng: np.random.Generator):
    """The headline operands on ``dev``: made there above
    :data:`HOST_OPERANDS_MAX_M` (seeds 0 and 1), else drawn from ``rng``."""
    if m > HOST_OPERANDS_MAX_M:
        made = []
        for seed in (0, 1):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            made.append(torch.rand((m, m), dtype=torch.float64, device=dev, generator=g))
        return tuple(made)
    a = rng.uniform(size=(m, m))
    b = rng.uniform(size=(m, m))
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def sampled_residual(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> dict:
    """The oracle's metrics of ``c = a @ b`` on ``bench_cli``'s sampled
    block (all of C up to 2^31 multiply-adds); only that block's rows of A
    and columns of B leave the device."""
    m, k = a.shape
    block = sampled_block(m, b.shape[1], k)
    if block is not None:
        rows, cols = (torch.from_numpy(x).to(c.device) for x in block)
        c, a, b = c[rows][:, cols], a[rows], b[:, cols]
    return oracle.error_metrics(c.cpu().numpy(), a.cpu().numpy(), b.cpu().numpy())


def timed_repeats(what: str, fn, iters: int, repeats: int, dev: torch.device) -> list:
    """ms per call in each of ``repeats`` runs of ``iters`` back-to-back
    calls of ``fn`` (after one warm call), with the peak allocated memory
    and the card's clocks and power before, in and after the runs on
    stderr."""
    fn()
    synchronize(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = smi_read(smi(dev))
    ms, during = [], []
    for _ in range(repeats):  # one query started as each repeat starts
        query = smi(dev)
        ms.append(_timed_calls(fn, iters, dev) / iters * 1e3)
        during.append(smi_read(query))
    after = smi_read(smi(dev))
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "not measured (no CUDA device)")
    log(f"{what}: ms per call in {repeats} repeats of {iters} calls: "
        + ", ".join(f"{t:.3f}" for t in ms)
        + f"; median {statistics.median(ms):.3f}, min {min(ms):.3f}, max {max(ms):.3f}; "
        f"peak allocated {peak} (operands included)")
    log(f"{what}: nvidia-smi {SMI_QUERY}: before [{before}], in each repeat "
        + ", ".join(f"[{x}]" for x in during) + f", after [{after}]")
    return ms


def run(m: int, ns: int, iters: int, repeats: int = REPEATS, device="cuda",
        acc_size: int = ACC_SIZE, skip_native: bool = False) -> dict:
    """The benchmark.  Returns ``{"record": the JSON line's four keys,
    "accuracy", "sampled": oracle metrics, "engine_ms", "native_ms": ms per
    call of each repeat (None without the baseline), "native_error",
    "engine_calls": the engine GEMMs it made}``.  Raises if the engine
    fails; a failed baseline gives ``vs_baseline`` None."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name} ({dev}); torch {torch.__version__}; M={m} ns={ns} iters={iters} "
        f"repeats={repeats}")
    mode = f"fp64_int8_{ns}"
    rng = np.random.default_rng(0)

    _, acc = accuracy_check(ns, acc_size, dev, rng)
    log(f"accuracy @{acc_size}^3 ns={ns}: residual={acc['relative_residual']:.3e} "
        f"max_rel={acc['max_relative_error']:.3e}")

    where = "on the card" if m > HOST_OPERANDS_MAX_M else "from numpy default_rng(0)"
    log(f"operands {m}x{m} float64 uniform [0, 1), {where}")
    a, b = operands(m, dev, rng)
    sampled = sampled_residual(gemm(a, b, mode=mode), a, b)
    log(f"headline product {m}^3 {mode}: residual={sampled['relative_residual']:.3e} "
        f"max_rel={sampled['max_relative_error']:.3e} on "
        + ("all of C" if sampled_block(m, m, m) is None else "a sampled 256 x 256 block"))

    engine_ms = timed_repeats(f"engine {mode} {m}^3", lambda: gemm(a, b, mode=mode), iters,
                              repeats, dev)
    t_engine = statistics.median(engine_ms) / 1e3
    tflops = 2 * m**3 / t_engine / 1e12
    log(f"engine: {t_engine * 1e3:.3f} ms/GEMM (median) -> {tflops:.3f} effective FP64 TFLOPS")

    native_ms, native_error, vs = None, None, None
    if skip_native:
        log("native baseline skipped (OZ_BENCH_SKIP_NATIVE=1)")
    else:
        # the engine's planes and accumulators are freed after each call;
        # hand their cached blocks back before the baseline runs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        try:
            native_ms = timed_repeats(f"torch.matmul float64 {m}^3", lambda: torch.matmul(a, b),
                                      iters, repeats, dev)
            native_tflops = 2 * m**3 / (statistics.median(native_ms) / 1e3) / 1e12
            vs = tflops / native_tflops
            log(f"native f64: {statistics.median(native_ms):.3f} ms/GEMM (median) -> "
                f"{native_tflops:.3f} TFLOPS; vs_baseline {vs:.4f}")
        except Exception as e:  # the record is printed whatever happens here
            native_ms, native_error = None, f"{type(e).__name__}: {e}"
            log(f"native baseline unavailable ({native_error}); emitting vs_baseline null")

    record = {"metric": metric(m, ns), "value": tflops, "unit": "TFLOPS", "vs_baseline": vs}
    return {"record": record, "accuracy": acc, "sampled": sampled, "engine_ms": engine_ms,
            "native_ms": native_ms, "native_error": native_error,
            "engine_calls": 3 + repeats * iters}


def main(device="cuda", acc_size: int = ACC_SIZE) -> int:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        log("bench_torch: torch.cuda.is_available() is false; this benchmark needs a CUDA GPU "
            "and does not run on the CPU")
        return 1
    try:
        res = run(repeats=REPEATS, device=dev, acc_size=acc_size, **knobs())
    except Exception:
        log(f"bench_torch: the engine failed\n{traceback.format_exc()}")
        return 1
    print(json.dumps(res["record"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
