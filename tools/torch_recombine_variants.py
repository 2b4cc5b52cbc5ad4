#!/usr/bin/env python3
"""Time the tile classes of the port's recombine kernel on one CUDA GPU.

    python3 tools/torch_recombine_variants.py [--shapes crossover] [--rounds 2]
        [--copies shipped,kept2x1,tiles,noload] [--calls 3] [--seconds 1]
    python3 tools/torch_recombine_variants.py --shapes long [--walks off,on]
        [--launches 10] [--soak 6] [--shares 2,3,4] [--long-shapes "m,n,k,batch[,ns];..."]
        [--long-modes fold,totals]

``--shapes`` is a list of ``m,n,k`` or ``m,n,k,batch`` separated by ``;``,
or a name: ``crossover`` (the launch plan's crossover: k = 1024 .. 16384 at
16384^2, HPL's two step shapes at N = 45056 and NB = 1024, 44032^2 x 1024
and 1024 x 44032 x 1024, the short-k products 15360^2 x 1024 and 8192^2 x
1024, 8192^3, 4096^2, 2048^2 and 1025 x 1023 at k = 1024, 1024^3, and the
batches 4 x 4096^3 and 8 x 1024^3), or ``quick`` (16384^2 x
1024 and 16384^3).  ns = 9 throughout.  Each copy of ``ozimmu_tpu_torch``
is timed in its own process, the copies in turns, round after round, and
inside a copy its classes in turns, mirrored (a, b, b, a; CUDA events
around at least ``--calls`` back-to-back launches and about ``--seconds``
of them, after one timed warm launch), with the SM clock, power draw and
throttle reasons read after each timing:

  * ``shipped``: this checkout's classes (``recombine_cuda.TILES``: 0 =
    128x256 in clusters of 2, 1 = 64x128, 2 = the kept class, 128x96 with
    the triple in registers, in clusters of 2x2), and what the launch plan
    chooses at each shape.  It also prints the ptxas lines of every
    recombine instantiation (registers, spills) and how many clusters of
    each size fit on the card at once;
  * ``kept2x1``: the kept class in clusters of 2x1 (B shared, A not);
  * ``tiles``: two classes the port does not ship, the 128x256 tile without
    a cluster and in clusters of four blocks;
  * ``noload``: class 0 with the fold's loads of the parked triple skipped.
    Its bits are wrong; it shows what those loads cost.

Every class of every copy but ``noload`` is first checked bitwise against
the plain version at 1000 x 1234 x 777.  Prints one JSON line per timing.
Exits non-zero without a GPU or if a source anchor that an alteration needs
has moved.

``--shapes long`` times class 0 alone at long k, in this checkout: 16384^3,
8192^3 and 4 x 4096^3 at ns = 9 (or ``--long-shapes``, ns 9 unless a fifth
number gives it), each launch on its own (CUDA events around
it, a synchronise between launches) after ``--soak`` seconds of launches
that bring the card to its power cap, ``--launches`` launches a turn, the
walks of ``--walks`` in turns, mirrored (off, on, on, off):

  * ``off``: the free persistent walk (window 0, whatever the plan says);
  * ``plan``: what the launch plan does with the card's L2 (the bounded-skew
    walk only where one cluster unit's planes exceed it);
  * ``on``: the bounded-skew walk forced wherever class 0 runs, with the
    window the card's L2 gives (``recombine_cuda.WINDOW_SHARE`` times the
    steps the L2 holds, or each of ``--shares`` in turn).

Each turn prints the launches' ms (least, median, most, and each), the
window, and the times producers had to wait and gave up waiting.
``--long-modes`` names the kernel's modes timed at each shape: ``fold``
(:func:`recombine`, its B planes made k-contiguous in the launch, as the
public path does) and ``totals`` (:func:`group_totals` on k-major planes,
storing the totals).  A checkout without the walk times
``off`` alone.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {
    "crossover": "16384,16384,1024;16384,16384,2048;16384,16384,4096;16384,16384,8192;"
                 "16384,16384,16384;44032,44032,1024;1024,44032,1024;15360,15360,1024;"
                 "8192,8192,1024;8192,8192,8192;4096,4096,1024;2048,2048,1024;"
                 "1025,1023,1024;1024,1024,1024;4096,4096,4096,4;1024,1024,1024,8",
    "quick": "16384,16384,1024;16384,16384,16384",
}
LONG = ((16384, 16384, 16384, 1), (8192, 8192, 8192, 1), (4096, 4096, 4096, 4))

SWITCH = "    case 2:  // the kept class folds only"
COLS = ("__host__ __device__ constexpr int cluster_cols(int mode) { return (mode & kWhat) == kKeep "
        "? 2 : 1; }")
FIT = "    if (grid > fit * CL) cfg.gridDim = dim3(fit * CL);\n"
FOLD_LOAD = "      if (!first && row < m && col < n) {"

WORKER = r"""
import json, re, subprocess, sys, torch
from ozimmu_tpu_torch import native
from ozimmu_tpu_torch.ops import recombine_cuda
from ozimmu_tpu_torch.ops.recombine import fold_group_totals, group_totals
from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

name, tiles, check, calls = sys.argv[1], [int(t) for t in sys.argv[3].split(",")], sys.argv[4] == "1", int(sys.argv[5])
seconds = float(sys.argv[6])
shapes = [tuple(int(x) for x in s.split(",")) for s in sys.argv[2].split(";")]
dev = torch.device("cuda")
sms = torch.cuda.get_device_properties(dev).multi_processor_count

def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

def planes(bsz, m, nn, k, ns, seed):
    b = bits_per_int8(k)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((bsz, m, k), dtype=torch.float64, device=dev, generator=g)
    bm = torch.rand((bsz, k, nn), dtype=torch.float64, device=dev, generator=g)
    if bsz == 1:
        a, bm = a[0], bm[0]
    return b, split_f64(a, ns, b)[0], split_f64_cols(bm, ns, b)[0]

native.lib()
if check:
    entry = "?"
    for line in native.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m[1]
        elif "recombine_kernel" in entry and ("registers" in line or "spill" in line):
            targs = re.search(r"recombine_kernel(I\w+EE)", entry)
            print(json.dumps({"copy": name, "kernel": "recombine_kernel<" + ",".join(
                re.findall(r"Li(-?\d+)E", targs[1])) + ">", "ptxas": line.strip()}), flush=True)
    b = bits_per_int8(777)
    da = split_f64(torch.from_numpy(generate_input("urand01", (1000, 777), seed=5)).to(dev), 9, b)[0]
    db = split_f64_cols(torch.from_numpy(generate_input("urand01", (777, 1234), seed=6)).to(dev), 9, b)[0]
    want = fold_group_totals(group_totals(da, db, 9, 777, b), 9, 777, b)
    for t in tiles:
        got = recombine_cuda.recombine(da, db, 9, b, 777, tile=t)
        if not all(torch.equal(w.view(torch.int32), g.view(torch.int32)) for w, g in zip(want, got)):
            raise SystemExit(f"{name}: tile class {t} differs from the plain version")
    del da, db, want, got
for shape in shapes:
    m, n, k = shape[:3]
    bsz = shape[3] if len(shape) > 3 else 1
    b, da, db = planes(bsz, m, n, k, 9, 0)
    chosen = recombine_cuda.launch_plan(m, n, k, 9, sms, batch=bsz).tile
    for t in tiles + tiles[::-1]:  # in turns, mirrored: a, b, b, a
        f = lambda: recombine_cuda.recombine(da, db, 9, b, k, tile=t)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        f()
        e.record()
        e.synchronize()
        # at least `calls` launches and about `seconds` of them
        reps = max(calls, min(50, int(seconds * 1e3 / s.elapsed_time(e)) + 1))
        s.record()
        for _ in range(reps):
            f()
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / reps
        print(json.dumps({"copy": name, "tile": t, "class": recombine_cuda.TILES[t],
                          "planned": chosen, "m": m, "n": n, "k": k, "batch": bsz, "calls": reps,
                          "ms": ms,
                          "int8_tops": bsz * 45 * 2 * m * n * k / ms / 1e9, "after": smi()}),
              flush=True)
    del da, db
"""


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"source anchor not found once: {old!r}")
    return text.replace(old, new)


def _copy(root: str, name: str) -> str:
    dst = os.path.join(root, name)
    shutil.copytree(os.path.join(REPO, "ozimmu_tpu_torch"), os.path.join(dst, "ozimmu_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


def _edit(path: str, *subs) -> None:
    with open(path) as f:
        text = f.read()
    for old, new in subs:
        text = _replace(text, old, new)
    with open(path, "w") as f:
        f.write(text)


def _cu(copy: str) -> str:
    return os.path.join(copy, "ozimmu_tpu_torch", "csrc", "recombine.cu")


def _py(copy: str) -> str:
    return os.path.join(copy, "ozimmu_tpu_torch", "ops", "recombine_cuda.py")


def make_copies(root: str, names) -> dict:
    """name -> (package root, tile classes to time, check bitwise)."""
    copies = {}
    for name in names:
        path = _copy(root, name)
        if name == "shipped":
            _edit(_cu(path), ("#include <cuda_runtime.h>", "#include <cuda_runtime.h>\n#include <cstdio>"),
                  (FIT, FIT + '    static int told[8] = {};\n'
                              '    if (!told[CL]++) printf("{\\"clusters_of\\": %d, \\"fit\\": %d}\\n", '
                              'CL, fit);\n'))
            copies[name] = (path, "0,1,2", "1")
        elif name == "kept2x1":
            _edit(_cu(path), (COLS, "__host__ __device__ constexpr int cluster_cols(int) { return 1; }"))
            copies[name] = (path, "2", "1")
        elif name == "tiles":
            _edit(_cu(path),
                  (SWITCH, "    case 3:\n      return launch<2, 256, 4, 1, MODE>(da, dbt, o0, o1, o2, tot, "
                           "add, m, n, ns, k_pad, batch, sch, grid, smem_bytes, nullptr, 0, s);\n"
                           "    case 4:\n      return launch<2, 256, 4, 4, MODE>(da, dbt, o0, o1, o2, tot, "
                           "add, m, n, ns, k_pad, batch, sch, grid, smem_bytes, nullptr, 0, s);\n"
                           + SWITCH))
            with open(_py(path), "a") as f:  # timed forced only: the plan never takes them
                f.write("\nTILES = TILES + ((2, 256, 4, 1, 1), (2, 256, 4, 4, 1))\n"
                        "TILE_RATE = TILE_RATE + (1e-9, 1e-9)\n"
                        "GROUP_COST = GROUP_COST + (0.0, 0.0)\n"
                        "LAUNCHES_BY_TILE = [0] * len(TILES)\n")
            copies[name] = (path, "3,4", "1")
        elif name == "noload":
            _edit(_cu(path), (FOLD_LOAD, "      if (false) {"))
            copies[name] = (path, "0", "0")
        else:
            raise SystemExit(f"unknown copy {name!r}")
    return copies


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def run_long(walks, launches: int, soak: float, shares, long_shapes=LONG,
             modes=("fold",)) -> int:
    """``--shapes long``: class 0 at long k, each launch timed on its own,
    the walks in turns (the module docstring)."""
    import dataclasses
    import statistics
    import time

    import torch

    sys.path.insert(0, REPO)
    from ozimmu_tpu_torch.ops import recombine_cuda as rc
    from ozimmu_tpu_torch.ops.recombine import padded_k
    from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
    from ozimmu_tpu_torch.schedule import bits_per_int8

    dev = torch.device("cuda")
    has_walk = hasattr(rc, "LOCKSTEP_LAUNCHES")
    if not has_walk:
        walks = ["off"]
    print(json.dumps({"walk_in_checkout": has_walk}), flush=True)
    plan_of = rc.launch_plan

    def set_window(on):  # launch_plan with the window set here, whatever the rule says
        def plan(m, n, k, ns, sms, tile=None, **kw):
            p = plan_of(m, n, k, ns, sms, tile, **kw)
            window = rc.lockstep_window(kw["l2_bytes"], p, m, n) \
                if on and p.tile in rc.WALK_TILES else 0
            return dataclasses.replace(p, window=window)
        return plan

    for shape in long_shapes:
        m, n, k, bsz = shape[:4]
        ns = shape[4] if len(shape) > 4 else 9
        b, kp = bits_per_int8(k), padded_k(k)
        g = torch.Generator(device=dev).manual_seed(k + bsz)
        a = torch.rand((bsz, m, k), dtype=torch.float64, device=dev, generator=g)
        bm = torch.rand((bsz, k, n), dtype=torch.float64, device=dev, generator=g)
        if bsz == 1:
            a, bm = a[0], bm[0]
        planes = (split_f64, split_f64_cols)
        da, db = (split(x, ns, b)[0] for split, x in zip(planes, (a, bm)))
        if "totals" in modes:  # the totals mode reads only k-major planes
            ka, kb = (split(x, ns, b, kp)[0] for split, x in zip(planes, (a, bm)))
        del a, bm
        turns = []
        for w in walks:
            turns += [(w, s) for s in (shares if w == "on" else [None])]
        for mode in modes:
            if mode == "totals":
                f = lambda: rc.group_totals(ka, kb, ns, b, k, tile=0)  # noqa: E731
            else:
                f = lambda: rc.recombine(da, db, ns, b, k, tile=0)  # noqa: E731
            for walk, share in turns + turns[::-1]:
                if share is not None:
                    rc.WINDOW_SHARE = share
                if has_walk and walk != "plan":
                    rc.launch_plan = set_window(walk == "on")
                try:
                    t_end = time.perf_counter() + soak
                    while time.perf_counter() < t_end:
                        f()
                        torch.cuda.synchronize()
                    ms, waits, window = [], [], None
                    seen = getattr(rc, "LOCKSTEP_LAUNCHES", 0)
                    for _ in range(launches):
                        s, e = torch.cuda.Event(enable_timing=True), \
                            torch.cuda.Event(enable_timing=True)
                        torch.cuda.synchronize()
                        s.record()
                        f()
                        e.record()
                        e.synchronize()
                        ms.append(s.elapsed_time(e))
                        if has_walk:
                            walked = rc.LOCKSTEP_LAUNCHES
                            last = rc.last_walk() if walked != seen else None
                            seen = walked
                            window = last["window"] if last else 0
                            waits.append(last and [last["waits"], last["releases"]])
                finally:
                    rc.launch_plan = plan_of
                print(json.dumps({
                    "m": m, "n": n, "k": k, "batch": bsz, "ns": ns, "mode": mode, "walk": walk,
                    "share": share, "window": window, "launches": launches,
                    "ms_least": min(ms), "ms_median": statistics.median(ms), "ms_most": max(ms),
                    "most_over_least": max(ms) / min(ms), "ms": ms,
                    "int8_tops_median": bsz * ns * (ns + 1) * m * n * k
                    / statistics.median(ms) / 1e9,
                    "waits_and_releases": waits, "after": _smi()}), flush=True)
        del da, db
        ka = kb = None
        torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="crossover")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--copies", default="shipped,kept2x1,tiles,noload")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--walks", default="off,on")
    ap.add_argument("--launches", type=int, default=10)
    ap.add_argument("--soak", type=float, default=6.0)
    ap.add_argument("--shares", default="")
    ap.add_argument("--long-shapes", default="")
    ap.add_argument("--long-modes", default="fold")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_recombine_variants: no CUDA GPU", file=sys.stderr)
        return 1
    if args.shapes == "long":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        shares = [float(x) for x in args.shares.split(",") if x] or [None]
        shapes = [tuple(int(x) for x in s.split(",")) for s in args.long_shapes.split(";")] \
            if args.long_shapes else LONG
        return run_long(args.walks.split(","), args.launches, args.soak, shares, shapes,
                        args.long_modes.split(","))
    shapes = SHAPES.get(args.shapes, args.shapes)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="oz_variants_") as root:
        copies = make_copies(root, args.copies.split(","))
        for r in range(args.rounds):
            for name, (path, tiles, check) in copies.items():
                proc = subprocess.run(
                    [sys.executable, "-c", WORKER, name, shapes, tiles,
                     "1" if check == "1" and r == 0 else "0", str(args.calls), str(args.seconds)],
                    cwd=path, env=dict(os.environ, PYTHONPATH=path), capture_output=True, text=True)
                sys.stdout.write(proc.stdout)
                if proc.returncode != 0:
                    print(proc.stderr, file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
