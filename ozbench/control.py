#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: for each seed,
the numbers of one unit of the program at the cell's own size, and the
numbers of the control, the plain reference put in the program's place
one precision below the configuration's (float32 for float64).

    python3 ozbench/control.py --workload <name> --seeds 1,2,3 [--only program|control]

One JSON line per seed on standard output.  The benchmark's own runs do
not run this; ``ozbench/tests/test_ozbench_control.py`` runs the same at
sizes that a test can hold.
"""

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(workload: str, seed: int, only=None, *, root: str = ROOT, bench_dir: str = HERE,
             device=None, program=None) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    from harness import device as devmod
    from harness import driver, spec

    cell = spec.find_cell(workload, root, bench_dir)
    if device is None:
        device = devmod.require_cuda(cell.chips)
    if program is None:
        program = importlib.import_module("ozimmu_tpu_torch")
    drv = driver.make(cell.config, cell.traffic, seed, device, program, bench_dir)
    drv.prepare()
    out = {"seed": seed}
    last = drv.run_units(1) if only in (None, "program") else None
    drv.release()
    if last is not None:
        out["program"] = drv.judge(0, last)
        del last
    if only in (None, "control"):
        out["control"] = drv.control()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--only", choices=("program", "control"))
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps({"workload": args.workload,
                          **readings(args.workload, int(s), args.only)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
