#!/usr/bin/env python3
"""Time the batched recombine kernel against one 2-D launch per matrix, and
against a variant plane layout, on one CUDA GPU.

    python3 tools/torch_batched_variants.py [--shapes 4x4096,8x1024] [--rounds 3]

For each shape B x n (B products n x n x n, ns = 9, urand01 operands), in
turns (the copies' order alternates from round to round), with CUDA events
over 10 calls a timing and the SM clock, power draw and throttle reasons
read after each timing:

  * ``shipped``: the package as it is: one launch over planes laid out
    [ns, B, rows, k] (``batched``), and one 2-D launch per matrix over
    that matrix's contiguous [ns, rows, k] planes (``per_matrix``);
  * ``matrix_major``: a copy whose recombine wrapper lays both operands'
    planes out [B, ns, rows, k] (one more copy of A's planes) and whose
    kernel reads plane p of matrix i at coordinate i * ns + p, so that
    each matrix's planes are contiguous as in a 2-D launch.  Checked
    bitwise against the shipped kernel first.

Prints one JSON line per timing.  Exits non-zero without a GPU or if a
source anchor that the variant needs has moved.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_recombine_variants import _copy, _edit  # noqa: E402

WORKER = r"""
import json, subprocess, sys, torch
from ozimmu_tpu_torch.ops import recombine_cuda
from ozimmu_tpu_torch.ops.split import split_f64, split_f64_cols
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

name, shapes = sys.argv[1], [tuple(int(v) for v in s.split("x")) for s in sys.argv[2].split(",")]
dev = torch.device("cuda")

def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_throttle_reasons.active",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

def timed(f):
    f()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(10):
        f()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / 10

for bsz, n in shapes:
    b = bits_per_int8(n)
    a = torch.from_numpy(generate_input("urand01", (bsz, n, n), seed=0)).to(dev)
    bm = torch.from_numpy(generate_input("urand01", (bsz, n, n), seed=1)).to(dev)
    da, db = split_f64(a, 9, b)[0], split_f64_cols(bm, 9, b)[0]
    del a, bm
    got = recombine_cuda.recombine(da, db, 9, b, n)
    digest = [float(x.double().sum()) for x in got]
    del got
    runs = {"batched": lambda: recombine_cuda.recombine(da, db, 9, b, n)}
    if name == "shipped" and bsz > 1:
        one = [(da[:, i].contiguous(), db[:, i].contiguous()) for i in range(bsz)]
        runs["per_matrix"] = lambda: [recombine_cuda.recombine(x, y, 9, b, n) for x, y in one]
    for how, f in runs.items():
        ms = timed(f)
        print(json.dumps({"copy": name, "how": how, "batch": bsz, "n": n, "ms": ms,
                          "int8_tops": 45 * 2 * bsz * n**3 / ms / 1e9, "digest": digest,
                          "after": smi()}), flush=True)
    del da, db, runs
    torch.cuda.empty_cache()
"""


def make_copies(root: str) -> dict:
    from torch_recombine_variants import REPO

    shipped = os.path.join(root, "shipped")
    os.symlink(REPO, shipped)
    mm = _copy(root, "matrix_major")
    _edit(os.path.join(mm, "ozimmu_tpu_torch", "csrc", "recombine.cu"),
          ("struct Schedule {\n  int n_groups;", "struct Schedule {\n  int n_groups;\n  int ns;"),
          ("  sch.n_groups = n_groups;", "  sch.n_groups = n_groups;\n  sch.ns = ns;"),
          ("const int pa = sch.pi[p] * batch + mat, pb = sch.pj[p] * batch + mat;",
           "const int pa = mat * sch.ns + sch.pi[p], pb = mat * sch.ns + sch.pj[p];"))
    _edit(os.path.join(mm, "ozimmu_tpu_torch", "ops", "recombine_cuda.py"),
          ("        da = _pad_k_major(da, plan.k_pad)\n"
           "        db = _pad_k_major(db.transpose(2, 3), plan.k_pad)",
           "        da = _pad_k_major(da.transpose(0, 1), plan.k_pad)\n"
           "        db = _pad_k_major(db.permute(1, 0, 3, 2), plan.k_pad)"))
    return {"shipped": shipped, "matrix_major": mm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="4x4096,2x8192,8x2048,8x1024,64x256,1x8192")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_batched_variants: no CUDA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="oz_batched_variants_") as root:
        copies = make_copies(root)
        names = list(copies)
        for r in range(args.rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                path = copies[name]
                proc = subprocess.run([sys.executable, "-c", WORKER, name, args.shapes], cwd=path,
                                      env=dict(os.environ, PYTHONPATH=path), capture_output=True,
                                      text=True)
                sys.stdout.write(proc.stdout)
                if proc.returncode != 0:
                    print(proc.stderr, file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
