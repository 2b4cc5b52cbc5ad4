#!/usr/bin/env python3
"""Run one cell of the benchmark of ``ozimmu_tpu_torch`` once.

    python3 ozbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA device.  The run makes the
cell's inputs on the card from ``--seed``, warms up the cell's shapes,
soaks the card with the cell's own calls until it runs at its power cap
(all of that is ``setup_s``), measures for ``--seconds``, then checks the
kept outputs against the plain reference under ``ozbench/reference/``.
With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiler window after the measured one; a per-layer metric that reads
nothing there is named on standard error.  The traced run also checks
that the engine products of the traced units launched engine kernels
(``engine_shortfall_pct``: the share that launched none, limit 50), so
products that fall back to a float64 library GEMM, or are not routed to
the engine, fail ``correct``.
Without a CUDA device the run fails; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "ozimmu_tpu")


def forbidden_modules(names=None) -> list:
    """The FORBIDDEN top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.partition(".")[0] for name in names} & set(FORBIDDEN))


def _judge(drv, kept, limits: dict):
    """(checks, failed): each number's worst value over the kept outputs
    beside its limit, and how many outputs broke a limit."""
    worst = {name: 0.0 for name in limits}
    failed = 0
    for i, out in kept:
        nums = drv.judge(i, out)
        bad = False
        for name, limit in limits.items():
            v = float(nums[name])
            if not math.isfinite(v) or v > limit:
                bad = True
            worst[name] = v if not math.isfinite(v) else max(worst[name], v)
        failed += bad
    checks = {name: {"value": worst[name] if math.isfinite(worst[name]) else str(worst[name]),
                     "limit": limits[name]} for name in limits}
    return checks, failed


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: str = ROOT,
             bench_dir: str = HERE, device=None, program=None, t_start: float = T_START) -> dict:
    """One run; the result's dict.  ``device`` and ``program`` stand in for
    the CUDA device and ``ozimmu_tpu_torch`` in the CPU tests."""
    import torch

    from harness import device as devmod
    from harness import driver, readers, spec, tracing

    def stamp(what: str) -> None:
        print(f"[setup] {what} at {time.perf_counter() - t_start:.3f} s", file=sys.stderr)

    cell = spec.find_cell(workload, root, bench_dir)
    if device is None:
        device = devmod.require_cuda(cell.chips)
    if program is None:
        program = importlib.import_module("ozimmu_tpu_torch")
    cuda = device.type == "cuda"
    stamp("imports and device")

    drv = driver.make(cell.config, cell.traffic, seed, device, program, bench_dir)
    drv.prepare()
    stamp("inputs and warm-up")
    soaked = drv.soak(float(cell.traffic.get("soak_s", 0.0)))
    setup_s = time.perf_counter() - t_start
    stamp(f"soak of {soaked} units")

    sampler = devmod.Sampler(devmod.Nvml(device))
    sampler.start()
    win = drv.window(seconds)
    sampler.stop()
    sampler.report()
    print(f"[window] {win.units} units in {win.seconds!r} s", file=sys.stderr)
    if win.unit_s:
        u = win.unit_s
        print(f"[window] unit ms: first {[round(1e3 * x, 3) for x in u[:3]]}, median "
              f"{1e3 * sorted(u)[len(u) // 2]!r}, min {1e3 * min(u)!r}, max {1e3 * max(u)!r}",
              file=sys.stderr)
    if win.latency_s:
        lat = sorted(win.latency_s)
        print(f"[window] latency ms: median {1e3 * lat[len(lat) // 2]!r}, "
              f"max {1e3 * lat[-1]!r}; mean issue {1e3 * sum(win.issue_s) / len(lat)!r}",
              file=sys.stderr)
    kept = list(win.kept)

    breakdown = None
    dev_extra = {}
    run_checks = {}
    if trace:
        n = int(cell.traffic["trace_units"])
        lead_s = float(cell.traffic.get("trace_lead_s", 0.0))
        trc, last = tracing.capture(lambda: drv.run_units(n), cuda, lead=lambda: drv.soak(lead_s))
        kept.append((n - 1, last))
        ctx = readers.Context(trc, n, drv.products() * n, win, sampler.median_clock())
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], bench_dir)(ctx)
            if value is None:
                print(f"[metric] {m['name']} read nothing in this cell: what it reads "
                      f"({spec.path_of('metrics', m['name'], bench_dir)}) is not in the trace",
                      file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_extra = {"busy_s": trc.busy_s, "window_s": trc.window_s}
        breakdown = {"device_ops": trc.device_ops(), "idle_gaps": trc.idle_gaps()}
        if cuda:
            run_checks["engine_shortfall_pct"] = {"value": readers.engine_shortfall_pct(ctx),
                                                  "limit": readers.ENGINE_SHORTFALL_LIMIT}
    else:
        measured = readers.Measured(win, drv)
        metrics = {}
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else \
                spec.end_to_end_reader(m["name"], bench_dir)(measured)
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {**devmod.describe(device, cell.chips), **dev_extra}
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = _judge(drv, kept, cell.limits)
    for name, c in run_checks.items():
        failed += c["value"] > c["limit"]
    checks.update(run_checks)
    result = {
        "correct": failed == 0,
        "attempted": win.units,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.device import NoDevice

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoDevice as e:
        print(f"ozbench: no device for this cell: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"ozbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
