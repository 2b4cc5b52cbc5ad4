#!/usr/bin/env python3
"""Accuracy-vs-throughput sweep of ozimmu_tpu_torch over fp64_int8_3..18 on
one CUDA GPU (the port of ``tools/pareto_sweep.py``; BASELINE.md's "Split
sweep int8_3..18 @ 4096^3").

Usage:  python tools/torch_pareto_sweep.py [SIZE] [MODE_LIST] [flags]
        python tools/torch_pareto_sweep.py 4096               # 3..18, dgemm, sgemm
        python tools/torch_pareto_sweep.py 4096 8,9,10 --complex   # ZGEMM rows
        python tools/torch_pareto_sweep.py 4096 dgemm,sgemm   # just those rows
        python tools/torch_pareto_sweep.py 8192 --no-oracle   # timing only
        python tools/torch_pareto_sweep.py 4096 --rounded-ref=r.csv  # + JAX tool's scoring

Integer tokens of MODE_LIST mean ``fp64_int8_<ns>``; names pass through.
With an explicit list the ``dgemm`` and ``sgemm`` rows are not appended.
Operands: ``generate_input("urand01", (SIZE, SIZE), seed=0 / 1)`` (complex
with ``--complex``).  Every row's result is kept on the host and all of
them are scored against ONE long-double accumulation of A @ B
(``oracle.error_metrics_multi``, its dot products on every host core);
``--no-oracle`` leaves the residual columns nan.  ``--rounded-ref=PATH``
also writes, for a real sweep, each row's metrics against that product
rounded to f64, as ``tools/pareto_sweep.py`` scores its real rows (its
reference is ``native.ref_gemm_native``), into a CSV
``mode,residual,max_relative`` at PATH, from the same oracle pass; the
committed ``tests/artifacts/torch_pareto_real_4096_rounded_ref.csv`` is
that file of the committed real sweep.  TFLOPS: 2mnk (x4
complex) over the mean of back-to-back calls (``testing.effective_tflops``,
CUDA events after a warm call), ``--test-count=N`` calls at least (default
10) and as many more as fill 0.25 s, so short rows (``sgemm`` at 4096^3
takes about 0.3 ms) are timed over a window much longer than the events'
resolution.

Prints a CSV (``device,gemm,input,mode,opA,opB,m,n,k,residual,max_relative,
tflops``) on stdout, and exits 1 if a row's timing failed (its tflops then
reads nan, as in the JAX tool).  Without a CUDA GPU it prints the reason to
stderr and exits 1: it does not run on the CPU.  ``sweep(..., device="cpu")``
does, for tests.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ozimmu_tpu_torch import oracle  # noqa: E402
from ozimmu_tpu_torch.bench_cli import CSV_HEADER, _device_name  # noqa: E402
from ozimmu_tpu_torch.core.api import gemm  # noqa: E402
from ozimmu_tpu_torch.schedule import effective_flops  # noqa: E402
from ozimmu_tpu_torch.testing import effective_tflops, generate_input  # noqa: E402

DEFAULT_MODES = [f"fp64_int8_{ns}" for ns in range(3, 19)]
FALLBACK_MODES = ["dgemm", "sgemm"]
TEST_COUNT = 10
MIN_WINDOW_S = 0.25
ROUNDED_REF_HEADER = "mode,residual,max_relative"


def modes_of(token_list=None) -> list:
    """The rows of a MODE_LIST argument (None: 3..18 then dgemm, sgemm)."""
    if token_list is None:
        return DEFAULT_MODES + FALLBACK_MODES
    return [f"fp64_int8_{t.strip()}" if t.strip().isdigit() else t.strip()
            for t in token_list.split(",")]


def timed_tflops(a, b, mode: str, test_count: int, device) -> float:
    """``effective_tflops`` over ``test_count`` calls, or over as many as
    fill :data:`MIN_WINDOW_S` at the rate of one timed call."""
    flops = effective_flops(a.shape[0], b.shape[1], a.shape[1],
                            np.iscomplexobj(a) or np.iscomplexobj(b))
    one_call = flops / (effective_tflops(a, b, mode, 1, device) * 1e12)
    n = max(1, test_count, math.ceil(MIN_WINDOW_S / one_call))
    return effective_tflops(a, b, mode, n, device)


def rounded_ref_metrics(c: np.ndarray, ref64: np.ndarray) -> dict:
    """``c``'s metrics against a float64 reference, as the JAX package's
    ``testing.error_metrics(c, a, b, c_ref=ref64)`` computes them."""
    diff = c - ref64
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(diff) / np.abs(ref64)
        rel = np.where(np.abs(ref64) == 0, 0.0, rel)
    return {"relative_residual": float(np.linalg.norm(diff) / np.linalg.norm(ref64)),
            "max_relative_error": float(np.max(rel))}


def sweep(size: int, modes, complex_: bool = False, with_oracle: bool = True,
          test_count: int = TEST_COUNT, device="cuda", log=None):
    """One row per mode: ``(rows, results, rounded)``, ``rows`` the CSV
    lines (no header), ``results`` each mode's product (numpy, on the host;
    empty with ``with_oracle=False``) and ``rounded`` the lines of
    ``--rounded-ref``'s file (no header; empty unless a real sweep is
    scored)."""
    a = generate_input("urand01", (size, size), seed=0, complex_=complex_)
    b = generate_input("urand01", (size, size), seed=1, complex_=complex_)
    results, tflops = {}, {}
    for mode in modes:
        if with_oracle:
            results[mode] = gemm(a, b, mode=mode, device=device)
        try:
            tflops[mode] = timed_tflops(a, b, mode, test_count, device)
        except Exception as e:  # keep the accuracy row even if timing fails
            if log:
                log(f"# timing failed for {mode}: {type(e).__name__}: {e}")
            tflops[mode] = float("nan")
        if log:
            log(f"# {mode}: {tflops[mode]:.4f} TFLOPS")
    nan = {"relative_residual": float("nan"), "max_relative_error": float("nan")}
    errs = dict.fromkeys(modes, nan)
    rounded = []
    if with_oracle:
        if log:
            log(f"# one long-double oracle product ({size}^3) for {len(modes)} rows")
        ref64 = None if complex_ else np.empty((size, size), dtype=np.float64)
        errs = dict(zip(modes, oracle.error_metrics_multi(
            [results[mode] for mode in modes], a, b, threads=len(os.sched_getaffinity(0)),
            ref64=ref64)))
        if ref64 is not None:
            for mode in modes:
                r = rounded_ref_metrics(results[mode], ref64)
                rounded.append(f"{mode},{r['relative_residual']:e},{r['max_relative_error']:e}")
    dev = _device_name(device)
    kind = "Z" if complex_ else "D"
    rows = [f"{dev},{kind},urand01,{mode},N,N,{size},{size},{size},"
            f"{errs[mode]['relative_residual']:e},{errs[mode]['max_relative_error']:e},"
            f"{tflops[mode]:e}" for mode in modes]
    return rows, results, rounded


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("torch_pareto_sweep: torch.cuda.is_available() is false; the sweep needs a CUDA "
              "GPU and does not run on the CPU", file=sys.stderr)
        return 1
    args = [x for x in argv if not x.startswith("--")]
    flags = {x for x in argv if x.startswith("--")}
    test_count, rounded_path = TEST_COUNT, None
    for f in flags:
        if f.startswith("--test-count="):
            test_count = int(f.split("=", 1)[1])
        if f.startswith("--rounded-ref="):
            rounded_path = f.split("=", 1)[1]
    if rounded_path and flags & {"--complex", "--no-oracle"}:
        print("torch_pareto_sweep: --rounded-ref scores a real sweep with the oracle",
              file=sys.stderr)
        return 2
    size = int(args[0]) if args else 4096
    modes = modes_of(args[1] if len(args) > 1 else None)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    rows, _, rounded = sweep(size, modes, complex_="--complex" in flags,
                             with_oracle="--no-oracle" not in flags, test_count=test_count,
                             device="cuda", log=log)
    print(CSV_HEADER)
    print("\n".join(rows), flush=True)
    if rounded_path:
        with open(rounded_path, "w") as f:
            f.write("\n".join([ROUNDED_REF_HEADER, *rounded]) + "\n")
    untimed = [row.split(",")[3] for row in rows if not math.isfinite(float(row.split(",")[-1]))]
    if untimed:
        log(f"# timing failed for {', '.join(untimed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
