"""Feeding a cluster-scale GEMM with O(shard) host memory per process.

The PyTorch/CUDA counterpart of ``09_north_star_feeding.py``.  At the
north-star configuration (131072^3) one f64 operand is ~137 GB — no host
can materialise it, so the wrappers that take a full numpy array cannot
feed that scale.  This example shows the production path:

1. ``shard_local_f64x(shape, mesh, spec, fill)`` — each rank synthesises
   (or mmap-loads) ONLY its own shard, straight into a float64 ``DTensor``
   on its device;
2. ``sharded_gemm_presharded(ax, bx, ns, mesh)`` — runs the distributed
   engine directly on the sharded operands: no gather, no host copy; the
   result stays a ``DTensor`` on the mesh.

    python examples/torch_09_north_star_feeding.py [--device cuda|cpu] [--backend nccl|gloo] \\
        [--n 512] [--nproc 4]

Run as a script it launches itself as ``--nproc`` rank processes on this
host (a 2 x 2 mesh for 4, 1 x 1 for 1) through
``ozimmu_tpu_torch.parallel.local``; the case table ``CASES`` reads the
size from ``OZIMMU_EXAMPLE_N``.  The demo size is small; the code is
identical at scale — only ``shape`` and the mesh change (16384^3 runs on
one H100 as a 1 x 1 mesh: ``--n 16384 --nproc 1``).  The check against
the same data built densely is possible only at demo sizes: up to
n = 4096 the residual is taken against the host's ``a @ b``, above it
against ``torch.matmul`` in float64 on the device, summed over k-panels
of 1024 (one call's own accumulation error is reported beside it) and,
on a sampled 256 x 256 block, against the long-double oracle.  NCCL ranks
need a GPU each: with more ranks than GPUs the script stops at once unless
``--backend gloo`` (ranks sharing a GPU) or ``--nproc 1`` is given.  Without
a GPU it stops at once unless ``--device cpu`` is given.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.parallel import (  # noqa: E402
    allgather_f64x,
    shard_local_f64x,
    sharded_gemm_presharded,
)
from ozimmu_tpu_torch.parallel.gemm import mesh_device  # noqa: E402

HERE = os.path.abspath(__file__)
#: above this n the dense check runs on the device and the oracle samples
HOST_CHECK_MAX_N = 4096
ORACLE_BLOCK = 256
#: the device reference sums ``torch.matmul`` over k-panels this wide: one
#: float64 call at k = 16384 on an H100 carries a relative error of 3.1e-15
#: on this data against the long-double oracle, panels of 1024 1.5e-16
REFERENCE_K_PANEL = 1024


def _device(name: str, nproc: int, backend) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    if dev.type == "cuda" and backend in (None, "nccl") and nproc > torch.cuda.device_count():
        raise RuntimeError(f"{nproc} NCCL ranks need {nproc} GPUs and this machine has "
                           f"{torch.cuda.device_count()}: pass --backend gloo to let the ranks share a GPU, or --nproc 1")
    return dev


# fill(idx) receives the GLOBAL index of one shard (a tuple of slices) and
# returns that block.  Here we synthesise deterministically from the global
# coordinates so every rank computes identical global data without ever
# holding it; a production loader would read the block from a parallel
# filesystem / np.load(..., mmap_mode="r")[idx].
def synth(shape_):
    def fill(idx):
        r = np.arange(*idx[0].indices(shape_[0]))[:, None]
        c = np.arange(*idx[1].indices(shape_[1]))[None, :]
        return np.sin(0.01 * r * shape_[1] + 0.013 * c) + 1.0
    return fill


def feed(m: int, n: int, k: int, mesh):
    """A (m x k) and B (k x n) as DTensors sharded (x, y), each rank
    filling only its own shard."""
    return (shard_local_f64x((m, k), mesh, ("x", "y"), synth((m, k))),
            shard_local_f64x((k, n), mesh, ("x", "y"), synth((k, n))))


def dense(shape, device) -> torch.Tensor:
    """The same operand built whole by the same fill (demo sizes only)."""
    return torch.from_numpy(synth(shape)(tuple(slice(0, s) for s in shape))).to(device)


def _shard_index(mesh, n: int):
    """This rank's (rows, cols) of an n x n matrix sharded (x, y)."""
    idx = []
    for dim in ("x", "y"):
        p = mesh.size(mesh.mesh_dim_names.index(dim))
        i, w = mesh.get_local_rank(dim), n // p
        idx.append(slice(i * w, (i + 1) * w))
    return tuple(idx)


def run(mesh, n: int):
    """The example on one rank: returns (results, operands) — the results
    the same on every rank, and the operands (the two DTensors, the dense
    tensors and the pre-sharded result) for a caller that measures them."""
    import torch.distributed as dist

    m = k = n
    ax, bx = feed(m, n, k, mesh)
    out = sharded_gemm_presharded(ax, bx, 9, mesh)  # the result stays on the mesh

    # check against the same data built densely (only possible at demo size)
    dev = mesh_device(mesh)
    a, b = dense((m, k), dev), dense((k, n), dev)
    want = ozt.gemm(a, b, mode="fp64_int8_9")
    rows, cols = _shard_index(mesh, n)
    local = out.to_local()
    same = torch.equal(local.view(torch.int64), want[rows, cols].view(torch.int64))
    res = dict(mesh=np.asarray(mesh.mesh.shape), n=n)
    if n <= HOST_CHECK_MAX_N:
        got = allgather_f64x(out)
        an, bn = a.cpu().numpy(), b.cpu().numpy()
        ref = an @ bn
        res.update(c=got, residual=np.linalg.norm(got - ref) / np.linalg.norm(ref))
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, bool(same))
    else:
        from ozimmu_tpu_torch import oracle

        ref = torch.zeros_like(want)
        for k0 in range(0, k, REFERENCE_K_PANEL):
            ref += torch.matmul(a[:, k0:k0 + REFERENCE_K_PANEL], b[k0:k0 + REFERENCE_K_PANEL])
        one_call = torch.matmul(a, b)
        part = [bool(same)]
        for r in (ref, one_call):  # this rank's squared error and norm against each
            part += [torch.sum((local - r[rows, cols]) ** 2).item(),
                     torch.sum(r[rows, cols] ** 2).item()]
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, part)
        total = np.sum([p[1:] for p in parts], axis=0)
        res["residual"] = float(np.sqrt(total[0] / total[1]))
        res["residual_one_matmul"] = float(np.sqrt(total[2] / total[3]))
        parts = [p[0] for p in parts]
        pick = np.random.default_rng(1)
        r_s = np.sort(pick.choice(n, ORACLE_BLOCK, replace=False))
        c_s = np.sort(pick.choice(n, ORACLE_BLOCK, replace=False))
        rt, ct = torch.from_numpy(r_s).to(dev), torch.from_numpy(c_s).to(dev)
        blk_a, blk_b = a[rt].cpu().numpy(), b[:, ct].cpu().numpy()
        res["oracle_residual"], res["one_matmul_oracle_residual"] = (
            oracle.error_metrics(x[rt][:, ct].cpu().numpy(), blk_a, blk_b)["relative_residual"]
            for x in (want, one_call))
        del ref, one_call
    res["bitwise"] = all(parts)
    return res, dict(ax=ax, bx=bx, a=a, b=b, out=out)


def north_star_case(mesh) -> dict:
    return run(mesh, int(os.environ.get("OZIMMU_EXAMPLE_N", "512")))[0]


CASES = {"north_star": north_star_case}


def main(device="cuda", n=512, backend=None, nproc=4, timeout=900.0) -> dict:
    """The case on ``nproc`` ranks (a 2 x 2 mesh for 4, 1 x 1 for 1);
    prints and returns rank 0's results."""
    from ozimmu_tpu_torch.parallel import local

    _device(device, nproc, backend)
    mesh = {1: "1x1", 4: "2x2"}[nproc]
    saved = os.environ.get("OZIMMU_EXAMPLE_N")
    os.environ["OZIMMU_EXAMPLE_N"] = str(n)
    try:
        ranks = local.run(f"{HERE}:CASES", mesh, nproc=nproc, device=device, backend=backend,
                          timeout=timeout)
    finally:
        if saved is None:
            del os.environ["OZIMMU_EXAMPLE_N"]
        else:
            os.environ["OZIMMU_EXAMPLE_N"] = saved
    for r, res in enumerate(ranks):
        if "north_star/error" in res:
            raise RuntimeError(f"rank {r} failed:\n{res['north_star/error']}")
    out = {k.split("/", 1)[1]: (v.item() if v.ndim == 0 else v)
           for k, v in ranks[0].items() if k.startswith("north_star/")}
    print("mesh:", tuple(int(v) for v in out["mesh"]),
          "bitwise == dense-fed engine:", out["bitwise"])
    print("residual:", out["residual"])
    if "oracle_residual" in out:
        print(f"residual against one torch.matmul call (its own float64 accumulation over "
              f"k = {n}): {out['residual_one_matmul']}")
        print(f"sampled {ORACLE_BLOCK}x{ORACLE_BLOCK} block, relative residual against the "
              f"long-double oracle: {out['oracle_residual']} (one torch.matmul call: "
              f"{out['one_matmul_oracle_residual']})")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--nproc", type=int, default=4, choices=(1, 4))
    args = ap.parse_args()
    main(args.device, args.n, args.backend, args.nproc)
