#!/usr/bin/env python3
"""What the program's spans (``utils/profiling.span``) cost, off and on.

    python3 tools/torch_span_cost.py [--calls 200] [--n 1024] [--device cuda]

Off: host microseconds to enter and leave ``span`` with no profiler
active, beside ``torch.profiler.record_function`` and an empty block, and
the two checks ``span`` could make: the module flag
``torch.autograd.profiler._is_profiler_enabled`` that it reads, and
``torch._C._autograd._profiler_enabled()`` (the best of 5 timings of
200000 each).

On: ``torch.matmul`` of n^3 float64 operands under
``intercept(mode="fp64_int8_9")``, each call synchronised, as the
benchmark's ``dgemm-1024-intercept`` cell runs it.  First ``--calls``
untraced calls (mean host issue time: from entering ``torch.matmul`` to
its return, before the synchronise), then as many inside the benchmark's
traced window (``ozbench/harness/tracing.capture``, after 50 calls of
lead-in: the first calls under a new profiler run far slower), read from
its Chrome trace: the mean host time of the ``aten::matmul`` event (the
issue time under the profiler), the mean time from its start to the
start of ``oz.intercept`` (torch's dispatch to the interceptor, which no
span of the program holds), and each ``oz.*`` span's mean self time a
call.  On the CPU (``--device cpu``) the interceptor's thresholds are
lowered to ``n``.

Prints the card's name and power limit first, one line a measurement,
and a JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "ozbench")]

import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
import ozimmu_tpu_torch.intercept as ozi  # noqa: E402
from harness import spans, tracing  # noqa: E402
from ozimmu_tpu_torch.utils import profiling  # noqa: E402

LEAD_CALLS = 50
LAYERS = ("oz.intercept", "oz.api", "oz.engine", "oz.split", "oz.recombine", "oz.epilogue")


def card(device: str) -> str:
    if device != "cuda":
        return "cpu"
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def off_cost() -> dict:
    """Microseconds an entry, with no profiler active."""
    def empty():
        pass

    def spanned():
        with profiling.span("oz.api"):
            pass

    def recorded():
        with torch.profiler.record_function("oz.api"):
            pass

    def flag():
        return torch.autograd.profiler._is_profiler_enabled

    number = 200000
    fns = (("empty", empty), ("span", spanned), ("record_function", recorded),
           ("check_flag", flag), ("check_c", torch._C._autograd._profiler_enabled))
    return {name: min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e6
            for name, fn in fns}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def on_cost(calls: int, n: int, device: str) -> dict:
    g = torch.Generator(device=device).manual_seed(17)
    a, b = (torch.rand((n, n), dtype=torch.float64, device=device, generator=g)
            for _ in range(2))
    h = ozt.create(device=device)
    h.intercept_threshold_m = h.intercept_threshold_n = h.intercept_threshold_k = min(n, 1024)

    def run(count):
        for _ in range(count):
            torch.matmul(a, b)
            _sync(device)

    issue = []
    with ozi.intercept(mode="fp64_int8_9", handle=h):
        run(8)
        for _ in range(calls):
            t0 = time.perf_counter()
            c = torch.matmul(a, b)
            issue.append(time.perf_counter() - t0)
            _sync(device)
        del c
        trace, _ = tracing.capture(lambda: run(calls), device == "cuda",
                                   lead=lambda: run(LEAD_CALLS))
    inside = [x for x in trace.host if trace.t0 <= x[0] <= trace.t1]
    mm = [x for x in inside if x[2] == "aten::matmul"]
    ic = sorted(s for s, _, name in inside if name == "oz.intercept")
    dispatch = []
    for s, e, _ in mm:  # the first interceptor span inside each matmul
        first = next((x for x in ic if s <= x <= e), None)
        if first is not None:
            dispatch.append(first - s)
    return {"calls": calls, "untraced_issue_us": 1e6 * sum(issue) / len(issue),
            "traced_matmul_us": sum(e - s for s, e, _ in mm) / max(1, len(mm)),
            "dispatch_to_intercept_us": sum(dispatch) / max(1, len(dispatch)),
            "self_us": {name: (spans.self_us(trace, name) or 0.0) / calls for name in LAYERS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_span_cost: no CUDA device", file=sys.stderr)
            return 2
        from ozimmu_tpu_torch import native

        native.lib()
    print(f"device: {card(args.device)}; torch {torch.__version__}")
    off = off_cost()
    print("off, us an entry: " + ", ".join(f"{k} {v:.3f}" for k, v in off.items()))
    on = on_cost(args.calls, args.n, args.device)
    print(f"on: untraced issue {on['untraced_issue_us']:.1f} us a call, traced aten::matmul "
          f"{on['traced_matmul_us']:.1f}, dispatch to oz.intercept "
          f"{on['dispatch_to_intercept_us']:.1f}")
    print("self us a call: " + ", ".join(f"{k} {v:.1f}" for k, v in on["self_us"].items()))
    print(json.dumps({"device": card(args.device), "off_us": off, **on}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
