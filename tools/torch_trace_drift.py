#!/usr/bin/env python3
"""Which device kernels torch.profiler keeps of a short call as a process
ages, on one CUDA GPU, under several ways of opening the trace.

    python3 tools/torch_trace_drift.py [--seconds 540] [--every 15] [--ways raw,warm,...]

Every ``--every`` seconds (the card and host kept busy in between with
float64 and engine GEMMs), traces one short engine call (``matmul``
1024^3 ``fp64_int8_9`` on numpy operands) in each of the ways that
``--ways`` picks, in order, and prints one line for each: the process's age, the way, the device kernels the trace kept
of the launches it saw, and a mask of the launches in issue order (``#``
its kernel kept, ``.`` dropped).  The ways:

- ``raw``: ``torch.profiler`` around the call alone; its line also gives
  kernel start - launch (us) over the pairs joined by their correlation
  id, and launch - host op (us) over the launches joined to the host op
  that made them by their external id.  A kernel starts a few
  microseconds after its launch, and a launch lies inside its host op; a
  negative or growing figure is a clock drifting from the other.
- ``warm``: a one-element add and a synchronisation inside the trace
  before the call.
- ``twice``: the call twice in one trace (a dropped prefix shows as dots
  at the start of the mask only).
- ``burst``: 64 one-element adds and a synchronisation inside the trace
  before the call (the mask shows the call's 14 launches; the adds are
  counted apart).
- ``spin``: one-element adds, each synchronised, for 0.1 s inside the
  trace before the call (the mask as for ``burst``).
- ``sleep_warm``: 0.1 s of sleep, then one add and a synchronisation,
  inside the trace before the call.
- ``device_trace``: ``ozimmu_tpu_torch.device_trace`` around the call,
  which opens with 64 adds (the mask as for ``burst``).

The default ways are ``raw,warm,twice,device_trace``.

Environment variables that the profiler reads (``TEARDOWN_CUPTI``, for
one) are printed first, after the card's name and power limit.  Exits
non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import glob
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


def _median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def _events(prof) -> list:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _launches(events) -> list:
    return sorted((e for e in events if e.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in e.get("name", "")), key=lambda e: float(e["ts"]))


def kept_mask(events) -> str:
    """``#`` for each launch (in issue order) whose kernel the trace kept,
    ``.`` for each whose kernel it dropped."""
    kernels = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    return "".join("#" if e["args"].get("correlation") in kernels else "." for e in _launches(events))


def clock_figures(events) -> str:
    """Median kernel start - launch and launch - host op (us) of a trace."""
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in _launches(events)}
    delta = [float(e["ts"]) - launch[e["args"].get("correlation")] for e in events
             if e.get("cat") == "kernel" and e["args"].get("correlation") in launch]
    ops = {e["args"]["External id"]: float(e["ts"]) for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    shift = [float(e["ts"]) - ops[e["args"]["External id"]] for e in _launches(events)
             if e.get("args", {}).get("External id") in ops]
    return f"kernel-launch us median={_median(delta):.1f} launch-op us median={_median(shift):.1f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=540.0)
    ap.add_argument("--every", type=float, default=15.0)
    ap.add_argument("--ways", default="raw,warm,twice,device_trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_drift: no CUDA GPU", file=sys.stderr)
        return 1
    import ozimmu_tpu_torch as ozt
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    print("env:", {k: v for k, v in os.environ.items() if "CUPTI" in k or "KINETO" in k},
          flush=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rng = np.random.default_rng(0)
    a, b = rng.uniform(size=(1024, 1024)), rng.uniform(size=(1024, 1024))
    big = torch.rand(8192, 8192, dtype=torch.float64, device="cuda")

    def call():
        ozt.matmul(a, b, mode="fp64_int8_9", device="cuda")

    def raw():
        with profile(activities=acts) as prof:
            call()
        return _events(prof)

    def warm():
        with profile(activities=acts) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            call()
        return _events(prof)

    def twice():
        with profile(activities=acts) as prof:
            call()
            call()
        return _events(prof)

    def burst():
        with profile(activities=acts) as prof:
            x = torch.ones(1, device="cuda")
            for _ in range(64):
                x.add_(1)
            torch.cuda.synchronize()
            call()
        return _events(prof)

    def spin():
        with profile(activities=acts) as prof:
            x = torch.ones(1, device="cuda")
            t = time.perf_counter()
            while time.perf_counter() - t < 0.1:
                x.add_(1)
                torch.cuda.synchronize()
            call()
        return _events(prof)

    def sleep_warm():
        with profile(activities=acts) as prof:
            time.sleep(0.1)
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            call()
        return _events(prof)

    def traced():
        with tempfile.TemporaryDirectory() as d:
            try:
                with ozt.device_trace(d):
                    call()
            except RuntimeError as e:
                print(f"  device_trace raised: {e}", flush=True)
            (path,) = glob.glob(os.path.join(d, "*.json"))
            with open(path) as f:
                return json.load(f)["traceEvents"]

    ways = {"raw": raw, "warm": warm, "twice": twice, "burst": burst, "spin": spin,
            "sleep_warm": sleep_warm, "device_trace": traced}
    WAYS = [(w, ways[w]) for w in args.ways.split(",")]
    call()
    t0 = time.time()
    while time.time() - t0 < args.seconds:
        for name, way in WAYS:
            events = way()
            mask = kept_mask(events)
            extra = f" {clock_figures(events)}" if name == "raw" else ""
            if name in ("burst", "spin", "device_trace"):  # the call's launches, the adds'
                mask, adds = mask[-14:], mask[:-14]
                extra = f" (adds before it: kept {adds.count('#')}/{len(adds)})"
            print(f"t={time.time() - t0:.1f}s {name}: kept {mask.count('#')}/{len(mask)} "
                  f"{mask}{extra}", flush=True)
        t1 = time.time()
        while time.time() - t1 < args.every:
            torch.matmul(big, big)
            ozt.gemm(big[:2048, :2048], big[:2048, :2048], mode="fp64_int8_9")
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
