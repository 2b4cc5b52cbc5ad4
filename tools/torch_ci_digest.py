#!/usr/bin/env python3
"""Run the whole 1944-case accuracy gate of ozimmu_tpu_torch on one CUDA GPU
and digest it into committed evidence (the port of ``tools/ci_digest.py``).

Usage: python tools/torch_ci_digest.py [--out-dir DIR] [--raw FILE] [--commit TEXT]

Runs ``bench_cli ci_test --seeds crc32`` (m, n, k in {1023, 1024, 1025},
op N/T on each side, fp64_int8_8..16, real and complex, residual < 1e-15
against the long-double oracle; the operand seeds of the JAX package's
``tools/ci_full_runner.py``) with its CSV output going to ``--raw``
(default ``runs/torch_ci_full.csv``, git-ignored), then groups the rows into
sets (kind, m x n x k, opA opB; nine modes each) and writes, into
``--out-dir`` (default ``tests/artifacts``):

  * ``torch_ci_full_real.log`` and ``torch_ci_full_complex.log``: one
    ``SET <kind>-<m>x<n>x<k>-<opA><opB> modes=9 failures=F max_residual=R``
    line per set, a ``FAIL ...`` line per failing case and a closing
    ``DONE kind=... cases=... failures=...`` line, the JAX runner's format;
  * ``torch_ci_full_digest.json``: the keys of the JAX digest
    (``tests/artifacts/ci_full_digest.json``), each half read back from its
    log as ``tools/ci_digest.py`` reads it, plus ``device`` (name and power
    limit from nvidia-smi), ``commit`` (``git rev-parse HEAD`` or
    ``--commit``), ``wall_seconds`` of the gate and its ``passed_line``.

Exits 0 iff all 1944 cases pass.  Without a CUDA GPU it prints the reason
to stderr and exits 1: it does not run on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ozimmu_tpu_torch import bench_cli  # noqa: E402

SIZES = (1023, 1024, 1025)
MODES = [f"fp64_int8_{ns}" for ns in range(8, 17)]
THRESHOLD = 1e-15
KINDS = {"D": "real", "Z": "complex"}

_PASSED = re.compile(r"^\s*(\d+)\s*/\s*(\d+)\s+PASSED\s*$")
_SET = re.compile(r"^SET (\S+) modes=(\d+) failures=(\d+)(?: max_residual=(\S+))?")
_DONE = re.compile(r"^DONE kind=(\S+) cases=(\d+) failures=(\d+)")


def set_logs(lines) -> tuple:
    """``ci_test`` output lines -> (``{"real": log text, "complex": log
    text}``, the ``N / N PASSED`` line or None, the seed scheme).  A case
    fails when its residual is not below :data:`THRESHOLD`."""
    sets = {}  # (kind, key) -> [(mode, residual, max_rel), ...], in output order
    passed, scheme = None, "fixed: seed 0 for A, 1 for B"
    for line in lines:
        line = line.rstrip("\n")
        if line.startswith("# seeds crc32:"):
            scheme = (f"{line.split(':', 1)[1].strip()} "
                      "(ozimmu_tpu_torch.bench_cli ci_test --seeds crc32)")
            continue
        if _PASSED.match(line):
            passed = line.strip()
            continue
        f = line.split(",")
        if len(f) != len(bench_cli.CSV_HEADER.split(",")) or f[1] not in KINDS:
            continue  # the "^^^ FAILED ^^^^" markers: the residual decides
        key = f"{KINDS[f[1]]}-{f[6]}x{f[7]}x{f[8]}-{f[4]}{f[5]}"
        sets.setdefault((KINDS[f[1]], key), []).append((f[3], float(f[9]), float(f[10])))
    logs = {}
    for kind in KINDS.values():
        out, cases, failures = [], 0, 0
        for (k, key), rows in sets.items():
            if k != kind:
                continue
            bad = [r for r in rows if not r[1] < THRESHOLD]
            out += [f"FAIL {key} {mode} residual={res:.3e} max_rel={mr:.3e}"
                    for mode, res, mr in bad]
            out.append(f"SET {key} modes={len(rows)} failures={len(bad)} "
                       f"max_residual={max(r[1] for r in rows):.3e}")
            cases += len(rows)
            failures += len(bad)
        out.append(f"DONE kind={kind} cases={cases} failures={failures}")
        logs[kind] = "\n".join(out) + "\n"
    return logs, passed, scheme


def digest_log(text: str, name: str) -> dict:
    """One half of the digest, read from its log as ``tools/ci_digest.py``
    reads the JAX runner's."""
    sets, done, fails = {}, None, []
    for line in text.splitlines():
        m = _SET.match(line)
        if m:
            key, modes, failures, mr = m.groups()
            sets[key] = {"modes": int(modes), "failures": int(failures),
                         **({"max_residual": float(mr)} if mr else {})}
            continue
        m = _DONE.match(line)
        if m:
            done = {"kind": m.group(1), "cases": int(m.group(2)), "failures": int(m.group(3))}
        if line.startswith("FAIL "):
            fails.append(line.strip())
    residuals = [s["max_residual"] for s in sets.values() if "max_residual" in s]
    return {
        "log": name,
        "sets": len(sets),
        "cases": sum(s["modes"] for s in sets.values()),
        "failures": sum(s["failures"] for s in sets.values()),
        "worst_set_residual": max(residuals) if residuals else None,
        "done": done,
        "fail_lines": fails,
        "per_set_max_residual": {k: s.get("max_residual") for k, s in sorted(sets.items())},
    }


def digest(lines, device: str, commit: str, wall_seconds: float, sizes=SIZES) -> tuple:
    """``(logs, digest)`` of a ``ci_test`` run's output ``lines``."""
    logs, passed, scheme = set_logs(lines)
    d = {
        "threshold": THRESHOLD,
        "sizes": list(sizes),
        "modes": MODES,
        "seed_scheme": scheme,
        "device": device,
        "commit": commit,
        "wall_seconds": wall_seconds,
        "passed_line": passed,
    }
    for kind in KINDS.values():
        d[kind] = digest_log(logs[kind], f"torch_ci_full_{kind}.log")
    return logs, d


def gpu_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def git_commit() -> str:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 else "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out-dir", default=os.path.join(ROOT, "tests", "artifacts"))
    p.add_argument("--raw", default=os.path.join(ROOT, "runs", "torch_ci_full.csv"))
    p.add_argument("--commit", default=None, help="what the digest names as the commit run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ci_digest: torch.cuda.is_available() is false; the gate needs a CUDA GPU "
              "and does not run on the CPU", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.raw)), exist_ok=True)
    t0 = time.perf_counter()
    with open(args.raw, "w") as raw, contextlib.redirect_stdout(raw):
        rc = bench_cli.run_ci_test(SIZES, "cuda", seeds="crc32")
    wall = time.perf_counter() - t0
    with open(args.raw) as raw:
        lines = raw.readlines()
    logs, d = digest(lines, gpu_label(), args.commit or git_commit(), wall)
    os.makedirs(args.out_dir, exist_ok=True)
    for kind, text in logs.items():
        with open(os.path.join(args.out_dir, d[kind]["log"]), "w") as f:
            f.write(text)
    out = os.path.join(args.out_dir, "torch_ci_full_digest.json")
    with open(out, "w") as f:
        json.dump(d, f, indent=1)
    total = d["real"]["cases"] + d["complex"]["cases"]
    failures = d["real"]["failures"] + d["complex"]["failures"]
    print(f"{total - failures}/{total} PASSED ({d['passed_line']}; ci_test rc {rc}) in "
          f"{wall:.1f} s on {d['device']} -> {out}")
    return 0 if (failures == 0 and total == 1944 and rc == 0) else 1


if __name__ == "__main__":
    sys.exit(main())
