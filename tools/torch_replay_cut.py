#!/usr/bin/env python3
"""Small products on one CUDA GPU, the engine's eager chain against its
replayed graph: where the replay's cuts (``schedule.REPLAY_MAX_WORK``,
``REPLAY_MAX_BYTES``) belong.

    python3 tools/torch_replay_cut.py [--calls 40] [--rounds 3] [--out FILE]

For each case, ``gemm(a, b, mode="fp64_int8_9")`` (with alpha = -1, beta
= 1 and a strided window of a wider matrix as c where the case says so,
as HPL's trailing update calls it) is timed three ways:

- a signature's first three calls on an empty cache, each synchronised:
  the eager first call, the second, which captures its chain, and the
  third, a replay; with the bytes the captured entry holds (the
  allocator's, as the cache counts them) beside ``replay_bytes``;
- synchronised calls, ``--calls`` a turn, issue to the return of the
  synchronise after each (a caller that reads each result);
- queued calls, ``--calls`` a turn issued back to back and synchronised
  once, the turn's time over its calls (a caller that issues ahead of
  the card);

each with the cuts below every product (the eager chain) and above every
product (the replay), in turns eager, replay, replay, eager for
``--rounds`` rounds.  Prints one JSON line per case: per side the median
and 95th percentile of a synchronised call, its median issue time on the
host and the median of a queued call (ms), the ratios replay / eager,
whether both sides gave the same bits, the product's int8 work and its
entry's bytes.  Writes every line to ``--out``.  Exits non-zero without a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.core import gemm as core  # noqa: E402
from ozimmu_tpu_torch.schedule import replay_bytes, schedule_flops  # noqa: E402

NS = 9
#: (m, n, k, complex, with c): squares around the work cut, outputs wide
#: against their k around the bytes cut, HPL's short-k products (trailing
#: updates with c, U12 products) and complex squares
CASES = [(s, s, s, False, False) for s in (512, 1024, 1536, 2048, 2560, 3072, 4096)] + [
    (4096, 4096, 256, False, False), (4096, 4096, 512, False, False),
    (8192, 8192, 64, False, False), (8192, 8192, 128, False, False),
    (2048, 2048, 1024, False, True), (3072, 3072, 1024, False, True),
    (1024, 8192, 1024, False, False), (1024, 16384, 1024, False, False),
    (512, 512, 512, True, False), (1024, 1024, 1024, True, True),
]


def card() -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        q = torch.cuda.get_device_name(0)
    return q


def operands(m, n, k, complex_, with_c, g):
    dtype = torch.complex128 if complex_ else torch.float64

    def rand(shape):
        return torch.rand(shape, dtype=dtype, device="cuda", generator=g) - 0.5

    a, b = rand((m, k)), rand((k, n))
    c = rand((m + 8, n + 16))[3:3 + m, 5:5 + n] if with_c else None
    return a, b, c


def synced(call, calls: int):
    """Latency and host issue time (s) of ``calls`` calls, each
    synchronised, and the last output."""
    lat, issue = [], []
    out = None
    for _ in range(calls):
        t0 = time.perf_counter()
        out = call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        issue.append(t1 - t0)
    return lat, issue, out


def queued(call, calls: int) -> float:
    """Seconds a call of ``calls`` calls issued back to back, synchronised
    once at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def cuts(side: str) -> None:
    """The replay's cuts below every product (``eager``) or above every
    product (``replay``)."""
    core.REPLAY_MAX_WORK = -1 if side == "eager" else float("inf")
    core.REPLAY_MAX_BYTES = -1 if side == "eager" else float("inf")


def p95(xs):
    s = sorted(xs)
    return s[max(0, -(-95 * len(s) // 100) - 1)]


def first_calls(call) -> dict:
    """The first three calls of the signature on an empty cache, each
    synchronised (ms), and the bytes its entry holds."""
    core._CACHE.clear()
    cuts("replay")
    times = [1e3 * sum(synced(call, 1)[0]) for _ in range(3)]
    return {"first_ms": times[0], "capture_ms": times[1], "third_ms": times[2],
            "held_bytes": core._CACHE.nbytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "runs", "replay_cut.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    label = card()
    print(f"# {label}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(22)
    lines = []
    for m, n, k, complex_, with_c in CASES:
        a, b, c = operands(m, n, k, complex_, with_c, g)
        alpha, beta = (-1.0, 1.0) if with_c else (1.0, 0.0)

        def call():
            return ozt.gemm(a, b, mode=f"fp64_int8_{NS}", alpha=alpha, beta=beta, c=c)

        first = first_calls(call)
        for name in ("eager", "replay"):  # warm each side
            cuts(name)
            for _ in range(3):
                call()
        torch.cuda.synchronize()
        captures = core.CAPTURES
        res = {"eager": ([], [], []), "replay": ([], [], [])}
        outs = {}
        for _ in range(args.rounds):
            for name in ("eager", "replay", "replay", "eager"):
                cuts(name)
                lat, issue, outs[name] = synced(call, args.calls)
                res[name][0].extend(lat)
                res[name][1].extend(issue)
            for name in ("eager", "replay", "replay", "eager"):
                cuts(name)
                res[name][2].append(queued(call, args.calls))
        side = {name: {"median_ms": 1e3 * statistics.median(lat), "p95_ms": 1e3 * p95(lat),
                       "issue_ms": 1e3 * statistics.median(issue),
                       "queued_ms": 1e3 * statistics.median(q)}
                for name, (lat, issue, q) in res.items()}
        x, y = outs["eager"], outs["replay"]
        same = torch.equal(torch.view_as_real(x).view(torch.int64) if complex_ else
                           x.view(torch.int64),
                           torch.view_as_real(y).view(torch.int64) if complex_ else
                           y.view(torch.int64))
        line = {"m": m, "n": n, "k": k, "complex": complex_, "c": with_c, "ns": NS,
                "work": schedule_flops(NS, m, n, k, complex_),
                "entry_bytes": replay_bytes(m, n, k, NS, complex_,
                                            (2 if complex_ else 1) if with_c else 0),
                **first, "calls": args.calls * 2 * args.rounds,
                **{f"{s}_{f}": v for s, d in side.items() for f, v in d.items()},
                "ratio_median": side["replay"]["median_ms"] / side["eager"]["median_ms"],
                "ratio_p95": side["replay"]["p95_ms"] / side["eager"]["p95_ms"],
                "ratio_queued": side["replay"]["queued_ms"] / side["eager"]["queued_ms"],
                "bits_equal": bool(same), "recaptures": core.CAPTURES - captures,
                "card": label}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del a, b, c, x, y, outs
        core._CACHE.clear()
        torch.cuda.empty_cache()
    with open(args.out, "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0 if all(x["bits_equal"] and not x["recaptures"] for x in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
