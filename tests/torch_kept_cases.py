"""The recombine kernel's kept class (the triple held in registers across a
tile's groups), forced, against the plain version and against the 128x256
class, bit for bit, at one ns: k in {16, 1000, 1024, 4096}, m x n in
{17 x 9, 130 x 260, 1025 x 1023}, batch 1 and 3.

    python tests/torch_kept_cases.py --ns 9

Run from the repository root on a CUDA GPU, in a process of its own (by
``test_torch_kernels_cuda.py``), so that a fault of the kernel cannot
disturb the other kernels' tests.  Prints one line per case, ``ok`` or
``MISMATCH``; exits 1 on any mismatch or without a GPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ozimmu_tpu_torch.ops import recombine as R
from ozimmu_tpu_torch.ops import recombine_cuda
from ozimmu_tpu_torch.ops import split as S
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

KS = (16, 1000, 1024, 4096)
SHAPES = ((17, 9), (130, 260), (1025, 1023))
BATCHES = (1, 3)


def _bits_equal(x, y) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(x, y))


def run(ns: int) -> int:
    dev = torch.device("cuda")
    bad = 0
    for k in KS:
        b = bits_per_int8(k)
        for m, n in SHAPES:
            for bsz in BATCHES:
                seed = 1000 * ns + k + m + bsz
                shape_a, shape_b = ((m, k), (k, n)) if bsz == 1 else ((bsz, m, k), (bsz, k, n))
                a = torch.from_numpy(generate_input("normal01", shape_a, seed=seed)).to(dev)
                bm = torch.from_numpy(generate_input("exp_rand-8", shape_b, seed=seed + 1)).to(dev)
                da, _ = S.split_f64(a, ns, b)
                db, _ = S.split_f64_cols(bm, ns, b)
                # the plain version on the card where its int8 products are large (cuBLASLt
                # refuses some small ones, k = 16 among them), else on the CPU
                on_card = bsz * m * n * k >= 2**27
                pa, pb = (da, db) if on_card else (da.cpu(), db.cpu())
                want = R.fold_group_totals(R.group_totals(pa, pb, ns, k, b), ns, k, b)
                before = list(recombine_cuda.LAUNCHES_BY_TILE)
                kept = recombine_cuda.recombine(da, db, ns, b, k, tile=recombine_cuda.KEPT_TILE)
                large = recombine_cuda.recombine(da, db, ns, b, k, tile=0)
                torch.cuda.synchronize()
                counted = [x - y for x, y in zip(recombine_cuda.LAUNCHES_BY_TILE, before)]
                kept = [x.to(want[0].device) for x in kept]
                large = [x.to(want[0].device) for x in large]
                ok = (_bits_equal(kept, want) and _bits_equal(kept, large)
                      and counted[recombine_cuda.KEPT_TILE] == 1 and counted[0] == 1)
                bad += not ok
                print(f"ns={ns} k={k} m={m} n={n} batch={bsz} {'ok' if ok else 'MISMATCH'} "
                      f"launches by class {counted}", flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kept_cases: no CUDA GPU", file=sys.stderr)
        return 1
    return run(args.ns)


if __name__ == "__main__":
    sys.exit(main())
