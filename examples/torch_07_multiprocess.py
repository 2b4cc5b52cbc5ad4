"""Multi-process (multi-host) sharded DGEMM demo.

The PyTorch/CUDA counterpart of ``07_multiprocess.py``.  On a real
cluster, each rank (e.g. started by ``torchrun``) just runs:

    from ozimmu_tpu_torch.parallel import launch
    launch.initialize()                  # torchrun's or the OZIMMU_* variables
    mesh = launch.make_mesh_2d_hybrid()  # hosts outer on x, each host's ranks inner
    ... sharded_gemm(a, b, 9, mesh) ...

For a one-machine demo this script launches 2 "hosts" x 2 ranks through
``ozimmu_tpu_torch.parallel.local``: four processes of one
``torch.distributed`` process group over TCP, each calling ``initialize``
and told that its host has 2 ranks (``LOCAL_WORLD_SIZE=2``), so that
``make_mesh_2d_hybrid`` builds the hierarchical grid.  Each process
verifies that the gathered result is bitwise-identical to the
single-device engine (``ozt.gemm_f64``).  The launcher kills every rank on
the first failure or after ``--timeout`` seconds and raises, so the script
exits non-zero if any rank failed.

    python examples/torch_07_multiprocess.py [--device cuda|cpu] [--backend nccl|gloo] [--n 512]

``--n`` is the contraction length k (A is 16x x k, B k x 16y on an x by y
mesh).  Four NCCL ranks need four GPUs: on one GPU pass ``--backend gloo``
so that the ranks share the card (the script stops at once otherwise).
Without a GPU it stops at once unless ``--device cpu`` is given.  The
ranks' body is the case table ``CASES`` (which reads k from
``OZIMMU_EXAMPLE_N``).
"""
import argparse
import os
import sys

HERE = os.path.abspath(__file__)
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.parallel import (  # noqa: E402
    allgather_f64x,
    make_mesh_2d_hybrid,
    replicated_f64x,
    sharded_gemm_fn,
)
from ozimmu_tpu_torch.parallel.gemm import mesh_device  # noqa: E402

NPROC, HOSTS = 4, 2


def _device(name: str, backend) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    if dev.type == "cuda" and backend in (None, "nccl") and NPROC > torch.cuda.device_count():
        raise RuntimeError(f"{NPROC} NCCL ranks need {NPROC} GPUs and this machine has "
                           f"{torch.cuda.device_count()}: pass --backend gloo to let the ranks "
                           "share a GPU")
    return dev


def operands(x: int, y: int, k: int):
    rng = np.random.default_rng(0)  # the same data on every process
    return rng.uniform(size=(16 * x, k)), rng.uniform(size=(k, 16 * y))


def multiprocess_case(mesh) -> dict:
    """One rank's part: build the hybrid mesh over the process group
    (``mesh`` gives only the device type), shard replicated operands, run
    the SUMMA body on the local blocks, gather, and compare with the
    single-device engine."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    mesh = make_mesh_2d_hybrid(device_type=mesh.device_type)  # hosts outer on x
    x, y = mesh.mesh.shape
    k = int(os.environ.get("OZIMMU_EXAMPLE_N", "512"))
    a, b = operands(x, y, k)
    m, n = a.shape[0], b.shape[1]

    A = replicated_f64x(a, mesh, ("x", "y"))
    B = replicated_f64x(b, mesh, ("x", "y"))
    out = sharded_gemm_fn(mesh, 9, k)(A.to_local(), B.to_local())
    C = DTensor.from_local(out, mesh, [Shard(0), Shard(1)], run_check=False,
                           shape=torch.Size((m, n)), stride=(n, 1))
    got = allgather_f64x(C)

    dev = mesh_device(mesh)
    ref = ozt.gemm_f64(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), 9).cpu().numpy()
    world = dist.get_world_size()
    return dict(mesh=np.asarray((x, y)), rank=dist.get_rank(), world=world,
                hosts=world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), got=got, ref=ref,
                bitwise=np.array_equal(got.view(np.uint64), ref.view(np.uint64)),
                residual=np.linalg.norm(got - a @ b) / np.linalg.norm(a @ b))


CASES = {"multiprocess": multiprocess_case}


def main(device="cuda", n=512, backend=None, timeout=300.0) -> dict:
    """The case on 2 "hosts" x 2 ranks; prints every rank's line and
    returns them with each rank's results (its launch counts included).
    Raises if a rank failed, hung or differs from the single-device
    engine."""
    from ozimmu_tpu_torch.parallel import local

    _device(device, backend)
    env = {"LOCAL_WORLD_SIZE": str(NPROC // HOSTS), "OZIMMU_EXAMPLE_N": str(n)}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)  # the launcher passes its environment to the ranks
    try:
        ranks = local.run(f"{HERE}:CASES", "2x2", nproc=NPROC, device=device, backend=backend,
                          timeout=timeout)
    finally:
        for key, val in saved.items():
            if val is None:
                del os.environ[key]
            else:
                os.environ[key] = val
    results, lines = [], []
    for r, res in enumerate(ranks):
        if "multiprocess/error" in res:
            raise RuntimeError(f"rank {r} failed:\n{res['multiprocess/error']}")
        out = {k.split("/", 1)[1]: (v.item() if v.ndim == 0 else v) for k, v in res.items()}
        x, y = (int(v) for v in out["mesh"])
        lines.append(f"process {out['rank']}/{out['world']}: mesh {x}x{y} over {out['hosts']} "
                     f"hosts, residual {out['residual']:.2e}, "
                     + ("bitwise == single-device" if out["bitwise"]
                        else "DIFFERS from single-device"))
        print(lines[-1])
        results.append(out)
    if not all(out["bitwise"] for out in results):
        raise RuntimeError("a rank differs from the single-device engine")
    print(f"all {NPROC} processes agreed bitwise with the single-device engine")
    return dict(lines=lines, results=results)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    ap.add_argument("--n", type=int, default=512, help="the contraction length k")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    main(args.device, args.n, args.backend, args.timeout)
