#!/usr/bin/env python3
"""Time variants of the port's recombine kernel on one CUDA GPU.

    python3 tools/torch_recombine_variants.py [--sizes 8192,4096] [--rounds 3]

Builds two altered copies of ``ozimmu_tpu_torch`` in a temporary directory
and times them against each other at n^3 for each size, ns = 9 (CUDA
events, 10 calls a timing), in turns, with the SM clock, power draw and
throttle reasons read after each timing:

  * ``tiles``: the shipped classes (0 and 1) plus two that the port does
    not ship, the 128x256 tile without a cluster (class 2) and in clusters
    of four blocks (class 3).  Each class is first checked bitwise against the
    plain version at 1000x1234x777, ns = 9, and the copy prints how many
    clusters of each size fit on the card at once;
  * ``noload``: the shipped kernel with the fold's loads of the parked
    triple skipped.  Its bits are wrong; it shows what those loads cost.

Prints one JSON line per timing.  Exits non-zero without a GPU or if a
source anchor that the alterations need has moved.
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

SWITCH = "    case 1:\n      return launch<1, 128, 8, 1>("
TILES = "TILES = ((2, 256, 4, 2), (1, 128, 8, 1))"
FIT = "    if (grid > fit * CM) cfg.gridDim = dim3(fit * CM);\n"
FOLD_LOAD = "      if (!first && row < m && col < n) {"

WORKER = r"""
import json, subprocess, sys, torch
from ozimmu_tpu_torch.ops import recombine_cuda
from ozimmu_tpu_torch.ops.recombine import fold_group_totals, group_totals
from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

name, sizes, tiles, check = sys.argv[1], [int(x) for x in sys.argv[2].split(",")], [int(t) for t in sys.argv[3].split(",")], sys.argv[4] == "1"
dev = torch.device("cuda")

def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

def planes(m, nn, k, ns, seed):
    b = bits_per_int8(k)
    a = torch.from_numpy(generate_input("urand01", (m, k), seed=seed)).to(dev)
    bm = torch.from_numpy(generate_input("urand01", (k, nn), seed=seed + 1)).to(dev)
    return b, split_f64(a, ns, b)[0], split_f64_cols(bm, ns, b)[0]

if check:
    b, da, db = planes(1000, 1234, 777, 9, 5)
    want = fold_group_totals(group_totals(da, db, 9, 777, b), 9, 777, b)
    for t in tiles:
        got = recombine_cuda.recombine(da, db, 9, b, 777, tile=t)
        if not all(torch.equal(w.view(torch.int32), g.view(torch.int32)) for w, g in zip(want, got)):
            raise SystemExit(f"{name}: tile class {t} differs from the plain version")
for n in sizes:
    b, da, db = planes(n, n, n, 9, 0)
    for t in tiles:
        f = lambda: recombine_cuda.recombine(da, db, 9, b, n, tile=t)
        f()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(10):
            f()
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e) / 10
        print(json.dumps({"copy": name, "tile": t, "class": recombine_cuda.TILES[t], "n": n,
                          "ms": ms, "int8_tops": 45 * 2 * n**3 / ms / 1e9, "after": smi()}),
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


def make_copies(root: str) -> dict:
    tiles = _copy(root, "tiles")
    _edit(os.path.join(tiles, "ozimmu_tpu_torch", "csrc", "recombine.cu"),
          ("#include <cuda_runtime.h>", "#include <cuda_runtime.h>\n#include <cstdio>"),
          (SWITCH, "    case 2:\n      return launch<2, 256, 4, 1>(da, dbt, p0, p1, p2, m, n, ns, "
                   "k_pad, batch, sch, grid, smem_bytes, s);\n"
                   "    case 3:\n      return launch<2, 256, 4, 4>(da, dbt, p0, p1, p2, m, n, ns, "
                   "k_pad, batch, sch, grid, smem_bytes, s);\n" + SWITCH),
          (FIT, FIT + '    static int told[8] = {};\n'
                      '    if (!told[CM]++) printf("{\\"clusters_of\\": %d, \\"fit\\": %d}\\n", '
                      'CM, fit);\n'))
    _edit(os.path.join(tiles, "ozimmu_tpu_torch", "ops", "recombine_cuda.py"),
          (TILES, "TILES = ((2, 256, 4, 2), (1, 128, 8, 1), (2, 256, 4, 1), (2, 256, 4, 4))"),
          ("tile = min((t for t in range(len(TILES))", "tile = min((t for t in range(2)"))
    noload = _copy(root, "noload")
    _edit(os.path.join(noload, "ozimmu_tpu_torch", "csrc", "recombine.cu"),
          (FOLD_LOAD, "      if (false) {"))
    return {"tiles": (tiles, "0,1,2,3", "1"), "noload": (noload, "0", "0")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="8192,4096")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_recombine_variants: no CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="oz_variants_") as root:
        copies = make_copies(root)
        for r in range(args.rounds):
            for name, (path, tiles, check) in copies.items():
                proc = subprocess.run(
                    [sys.executable, "-c", WORKER, name, args.sizes, tiles,
                     "1" if check == "1" and r == 0 else "0"],
                    cwd=path, env=dict(os.environ, PYTHONPATH=path), capture_output=True, text=True)
                sys.stdout.write(proc.stdout)
                if proc.returncode != 0:
                    print(proc.stderr, file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
