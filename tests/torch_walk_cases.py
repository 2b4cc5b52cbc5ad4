"""The recombine kernel's bounded-skew walk, forced at small shapes with
the window that a small stand-in for the card's L2 gives, against the free
walk and the plain version, bit for bit.

    python tests/torch_walk_cases.py --case partial-wave

Cases (``CASES``): a partial last wave (70 units on 66 clusters), fewer
units than clusters (the grid forced wider than the plan's: clusters with
no unit at all), a batch of 3, odd m and n, ns = 3 and 18, and the totals
mode; windows of 1 step (every cluster within one step of the slowest) and
of a few.  Each launch with the walk is counted in
``recombine_cuda.LOCKSTEP_LAUNCHES``, and its producers' waits and
releases are read back (``recombine_cuda.last_walk``): no producer may
give up waiting, and at a window of 1 over 66 clusters some must wait.

Run from the repository root on a CUDA GPU, one case a process (by
``test_torch_kernels_cuda.py``, each under its own time limit), so that a
hang of one case fails it and no other.  Prints one line per check, ``ok``
or ``MISMATCH``; exits 1 on any mismatch or without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ozimmu_tpu_torch.ops import recombine as R
from ozimmu_tpu_torch.ops import recombine_cuda
from ozimmu_tpu_torch.ops import split as S
from ozimmu_tpu_torch.schedule import bits_per_int8
from ozimmu_tpu_torch.testing import generate_input

#: name -> (batch, m, n, k, ns, L2 stand-in in bytes, grid forced or None,
#: totals mode); an L2 of 1 byte gives a window of 1 step, 1 MiB one of 5
CASES = {
    "partial-wave": (1, 1792, 2560, 2048, 9, 1, None, False),
    "partial-wave-window": (1, 1792, 2560, 2048, 9, 2**20, None, False),
    "fewer-units": (1, 512, 768, 1000, 9, 1, 132, False),
    "batch3": (3, 300, 520, 2000, 9, 1, None, False),
    "odd": (1, 1025, 1023, 1025, 9, 1, None, False),
    "ns3": (1, 1000, 1234, 777, 3, 1, None, False),
    "ns18": (1, 1000, 1234, 777, 18, 1, None, False),
    "totals": (1, 1792, 2560, 2048, 9, 1, None, True),
}

def _forced(plan_of, grid, walk):
    """launch_plan with the grid forced wider and the window set here, not
    by the rule (tested on the CPU, it engages none of these small shapes):
    while ``walk["l2"]`` is None the free walk (window 0), else, in class 0,
    the window that an L2 of that many bytes gives."""
    def plan(m, n, k, ns, sms, tile=None, **kw):
        p = plan_of(m, n, k, ns, sms, tile, **kw)
        if grid is not None:
            p = dataclasses.replace(p, grid=grid)
        window = 0
        if walk["l2"] is not None and p.tile in recombine_cuda.WALK_TILES:
            window = recombine_cuda.lockstep_window(walk["l2"], p, m, n)
        return dataclasses.replace(p, window=window)
    return plan


def _bits_equal(x, y) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(x, y))


def run(case: str) -> int:
    bsz, m, n, k, ns, l2, grid, totals = CASES[case]
    dev = torch.device("cuda")
    b = bits_per_int8(k)
    shape_a, shape_b = ((m, k), (k, n)) if bsz == 1 else ((bsz, m, k), (bsz, k, n))
    a = torch.from_numpy(generate_input("normal01", shape_a, seed=m + k)).to(dev)
    bm = torch.from_numpy(generate_input("exp_rand-8", shape_b, seed=n + k)).to(dev)
    kp = R.padded_k(k)
    da, _ = S.split_f64(a, ns, b, kp)
    db, _ = S.split_f64_cols(bm, ns, b, kp)
    plan_of, walk = recombine_cuda.launch_plan, {"l2": None}
    recombine_cuda.launch_plan = _forced(plan_of, grid, walk)
    plain = R.group_totals(da, db, ns, k, b, b_kmajor=True)  # on the card: the products are large
    if totals:
        want = torch.stack(plain)
        launch = lambda: recombine_cuda.group_totals(da, db, ns, b, k, tile=0)  # noqa: E731
        same = torch.equal
    else:
        want = R.fold_group_totals(plain, ns, k, b)
        launch = lambda: recombine_cuda.recombine(da, db, ns, b, k, tile=0,  # noqa: E731
                                                  b_kmajor=True)
        same = _bits_equal
    free = launch()
    before = recombine_cuda.LOCKSTEP_LAUNCHES
    walk["l2"] = l2
    walked = launch()
    torch.cuda.synchronize()
    recombine_cuda.launch_plan = plan_of
    counted = recombine_cuda.LOCKSTEP_LAUNCHES - before
    walk = recombine_cuda.last_walk()
    units = bsz * -(-m // 256) * -(-n // 256)  # class 0's units of 256 x 256
    must_wait = walk is not None and walk["window"] == 1 and units >= 66
    ok = (same(walked, want) and same(walked, free) and same(free, want) and counted == 1
          and walk is not None and walk["releases"] == 0 and (walk["waits"] > 0 or not must_wait))
    print(f"{case}: batch={bsz} m={m} n={n} k={k} ns={ns} totals={totals} units={units} "
          f"walk {walk} launches with the walk {counted} {'ok' if ok else 'MISMATCH'}",
          flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", required=True, choices=sorted(CASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_walk_cases: no CUDA GPU", file=sys.stderr)
        return 1
    return run(args.case)


if __name__ == "__main__":
    sys.exit(main())
