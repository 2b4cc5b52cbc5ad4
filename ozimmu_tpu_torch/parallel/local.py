"""Run a table of named cases on a mesh of rank processes on this host.

    python -m ozimmu_tpu_torch.parallel.local --cases FILE.py:TABLE --mesh 2x2 \\
        [--nproc 4] [--device cuda|cpu] [--backend nccl|gloo] [--timeout S] \\
        [--out results.npz]

Starts ``--nproc`` processes with ``subprocess``, each one rank of a
``torch.distributed`` process group over TCP on localhost (see
:func:`.launch.initialize`).  Each rank builds the mesh (``2x2``, ``1x4``,
... with dims ``("x", "y")``, or ``k4``: 1-D with dim ``"k"``) and calls
every case of ``TABLE``, a dict ``name -> fn(mesh) -> dict`` of arrays,
tensors, numbers or strings, in order.  Per case and rank it records the
results, the traceback of an exception (``<case>/error``), and the whole
case's seconds, split, exponent, recombine (both modes), totals-fold, epilogue, fold and estimator
kernel launches and bytes staged through host memory (``<case>/case_seconds``, ``case_launches_*``,
``case_staged_bytes``); each rank writes them to its own ``.npz``.  The parent waits with
a timeout: a rank that fails or hangs has every rank killed and raises, so
a hung collective fails a test or a phase, never the run around it.

The port's counterpart of the JAX tests' virtual-device meshes and of
``tests/mp_worker.py``; :func:`run` is the same from Python.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_cases(ref: str) -> dict:
    """``path/to/file.py:NAME`` or ``package.module:NAME`` -> the table."""
    where, _, name = ref.rpartition(":")
    if not where or not name:
        raise ValueError(f"cases must be FILE.py:NAME or module:NAME, got {ref!r}")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"_oz_cases_{os.path.splitext(os.path.basename(where))[0]}", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def mesh_from_spec(spec: str, device_type: str):
    """``"XxY"`` -> an (X, Y) mesh with dims ("x", "y"); ``"kP"`` -> a 1-D
    mesh of P ranks with dim "k"."""
    from torch.distributed.device_mesh import init_device_mesh

    if spec.startswith("k"):
        return init_device_mesh(device_type, (int(spec[1:]),), mesh_dim_names=("k",))
    xs, ys = (int(v) for v in spec.split("x"))
    return init_device_mesh(device_type, (xs, ys), mesh_dim_names=("x", "y"))


def _value(v) -> np.ndarray:
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _run_case(name: str, fn, mesh, cuda: bool) -> Dict[str, np.ndarray]:
    """One case on this rank, with the whole case's launches, staged bytes
    and seconds (a case that times a part of itself names its own keys)."""
    import torch
    import torch.distributed as dist

    from ..ops import epilogue_cuda, exponent_cuda, mantissa_loss_cuda, recombine_cuda, split_cuda
    from . import comm

    dist.barrier()
    if cuda:
        torch.cuda.synchronize()
    split_cuda.LAUNCHES = exponent_cuda.LAUNCHES = recombine_cuda.LAUNCHES = 0
    recombine_cuda.TOTALS_LAUNCHES = recombine_cuda.FOLD_LAUNCHES = 0
    epilogue_cuda.LAUNCHES = epilogue_cuda.ZFOLD_LAUNCHES = 0
    mantissa_loss_cuda.LAUNCHES = 0
    comm.STAGED_BYTES = 0
    t0 = time.perf_counter()
    try:
        out = {k: _value(v) for k, v in fn(mesh).items()}
        if cuda:
            torch.cuda.synchronize()
    except Exception:  # recorded per case; the other cases still run
        out = {"error": np.asarray(traceback.format_exc())}
    out.update(case_seconds=np.asarray(time.perf_counter() - t0),
               case_launches_split_digits=np.asarray(split_cuda.LAUNCHES),
               case_launches_row_exponent=np.asarray(exponent_cuda.LAUNCHES),
               case_launches_recombine=np.asarray(recombine_cuda.LAUNCHES),
               case_launches_recombine_totals=np.asarray(recombine_cuda.TOTALS_LAUNCHES),
               case_launches_totals_fold=np.asarray(recombine_cuda.FOLD_LAUNCHES),
               case_launches_epilogue=np.asarray(epilogue_cuda.LAUNCHES),
               case_launches_zfold=np.asarray(epilogue_cuda.ZFOLD_LAUNCHES),
               case_launches_mantissa_loss=np.asarray(mantissa_loss_cuda.LAUNCHES),
               case_staged_bytes=np.asarray(comm.STAGED_BYTES))
    return {f"{name}/{k}": v for k, v in out.items()}


def _rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from .launch import initialize

    torch.set_num_threads(1)  # the ranks share the host's cores
    initialize(f"127.0.0.1:{args.port}", args.nproc, args.rank, device=args.device,
               backend=args.backend)
    try:
        device_type = torch.device(args.device).type
        mesh = mesh_from_spec(args.mesh, device_type)
        results: Dict[str, np.ndarray] = {}
        for name, fn in load_cases(args.cases).items():
            results.update(_run_case(name, fn, mesh, device_type == "cuda"))
        np.savez(args.out, **results)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run(cases: str, mesh: str, nproc: int = 4, device: str = "cuda",
        backend: Optional[str] = None, timeout: float = 600.0) -> List[Dict[str, np.ndarray]]:
    """Run the table ``cases`` on ``mesh`` in ``nproc`` rank processes and
    return each rank's results (a list indexed by rank).  Raises
    ``TimeoutError`` if the ranks are not done within ``timeout`` seconds
    and ``RuntimeError`` if one exits non-zero; either way every rank is
    killed first."""
    with tempfile.TemporaryDirectory(prefix="oz_local_") as workdir:
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
        outs = [os.path.join(workdir, f"rank{r}.npz") for r in range(nproc)]
        logs = [os.path.join(workdir, f"rank{r}.log") for r in range(nproc)]
        procs = []
        try:
            for r in range(nproc):
                cmd = [sys.executable, "-m", "ozimmu_tpu_torch.parallel.local", "--rank", str(r),
                       "--nproc", str(nproc), "--port", str(port), "--cases", cases, "--mesh", mesh,
                       "--device", device, "--out", outs[r]]
                if backend:
                    cmd += ["--backend", backend]
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                  env=env))
            deadline = time.monotonic() + timeout
            while True:
                rcs = [p.poll() for p in procs]
                bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
                if bad:
                    raise RuntimeError(f"rank {bad[0]} of {mesh} exited with {rcs[bad[0]]}:\n"
                                       f"{_tail(logs[bad[0]])}")
                if all(rc == 0 for rc in rcs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{mesh}: ranks not done after {timeout} s (exit codes {rcs}); rank 0 "
                        f"says:\n{_tail(logs[0])}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for path in outs:
            with np.load(path) as f:
                results.append({k: f[k] for k in f.files})
        return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", required=True, help="FILE.py:NAME or module:NAME")
    ap.add_argument("--mesh", required=True, help="XxY (dims x, y) or kP (dim k)")
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None, help="the merged results (.npz)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    results = run(args.cases, args.mesh, args.nproc, args.device, args.backend, args.timeout)
    failed = 0
    for key in sorted(results[0]):
        if key.endswith("/case_seconds"):
            case = key[: -len("/case_seconds")]
            errors = [r for r, res in enumerate(results) if f"{case}/error" in res]
            failed += bool(errors)
            print(f"{case}: {'FAILED on ranks ' + str(errors) if errors else 'ok'} "
                  f"({float(results[0][key]):.3f} s on rank 0)")
    if args.out:
        np.savez(args.out, **{f"rank{r}/{k}": v for r, res in enumerate(results)
                             for k, v in res.items()})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
