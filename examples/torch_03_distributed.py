"""Multi-GPU sharded DGEMM over a ``torch.distributed`` device mesh.

The PyTorch/CUDA counterpart of ``03_distributed.py``:

    python examples/torch_03_distributed.py [--device cuda|cpu] [--backend nccl|gloo] [--n 256]

Run as a script it launches itself as 4 rank processes on this host (one
``torch.distributed`` process group over TCP, a 2 x 2 mesh) through
``ozimmu_tpu_torch.parallel.local`` and prints rank 0's findings.  Each
finding is a case of ``CASES``, a function of the mesh that every rank
calls, so the table also runs on its own, on any mesh of 4 ranks:

    python -m ozimmu_tpu_torch.parallel.local \\
        --cases examples/torch_03_distributed.py:CASES --mesh 2x2 --device cpu

All cross-rank traffic is int8 digit planes, int32 exponents and int32
group totals; results are bit-identical to the single-device engine.  On
one GPU four ranks cannot share an NCCL communicator: ``--backend gloo``
is the explicit choice there (collectives staged through host memory),
and without it the script stops at once when the ranks outnumber the GPUs.
Without a GPU it stops at once unless ``--device cpu`` is given.  The
case functions read the size from ``OZIMMU_EXAMPLE_N`` (set by
:func:`main`; default 256): A is n x 2n, B 2n x n/2, as in the JAX example.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ozimmu_tpu_torch as ozt  # noqa: E402
from ozimmu_tpu_torch.parallel import (  # noqa: E402
    make_mesh_2d,
    sharded_auto_mode_select,
    sharded_gemm,
    sharded_gemm_auto,
)
from ozimmu_tpu_torch.parallel.gemm import mesh_device  # noqa: E402

HERE = os.path.abspath(__file__)


def _device(name: str, nproc: int, backend) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU (torch.cuda.is_available() is false); "
                           "pass --device cpu to run on the CPU")
    if dev.type == "cuda" and backend in (None, "nccl") and nproc > torch.cuda.device_count():
        raise RuntimeError(f"{nproc} NCCL ranks need {nproc} GPUs and this machine has "
                           f"{torch.cuda.device_count()}: pass --backend gloo to let the ranks share a GPU")
    return dev


def data(n: int) -> dict:
    """Every operand of the example, drawn in the JAX example's order."""
    rng = np.random.default_rng(0)
    d = dict(a=rng.uniform(size=(n, 2 * n)), b=rng.uniform(size=(2 * n, n // 2)))
    d["c0"] = rng.uniform(size=(n, n // 2))
    d["za"] = rng.normal(size=(n, 2 * n)) + 1j * rng.normal(size=(n, 2 * n))
    d["zb"] = rng.normal(size=(2 * n, n // 2)) + 1j * rng.normal(size=(2 * n, n // 2))
    d["aw"] = d["a"] * np.exp2(rng.integers(-10, 10, d["a"].shape).astype(float))
    d["bw"] = d["b"] * np.exp2(rng.integers(-10, 10, d["b"].shape).astype(float))
    kt = 16 * n  # tall contraction: routed to the 1-D k-sharded ZGEMM
    d["zk_a"] = rng.normal(size=(16, kt)) + 1j * rng.normal(size=(16, kt))
    d["zk_b"] = rng.normal(size=(kt, 16)) + 1j * rng.normal(size=(kt, 16))
    return d


def _data() -> dict:
    return data(int(os.environ.get("OZIMMU_EXAMPLE_N", "256")))


def _same_bits(x: np.ndarray, y: np.ndarray) -> bool:
    return x.shape == y.shape and np.array_equal(
        np.ascontiguousarray(x).view(np.uint64), np.ascontiguousarray(y).view(np.uint64))


def summa(mesh) -> dict:
    d = _data()
    a, b = d["a"], d["b"]
    c = sharded_gemm(a, b, 9, mesh)
    c_local = ozt.gemm(a, b, mode="fp64_int8_9", device=mesh_device(mesh))
    return dict(mesh=np.asarray(mesh.mesh.shape), c=c, c_local=c_local,
                residual=np.linalg.norm(c - a @ b) / np.linalg.norm(a @ b),
                bitwise=_same_bits(c, c_local))


def epilogue(mesh) -> dict:
    """The full gemm contract on the mesh: alpha*(a@b) + beta*c, the same
    exact epilogue as the single-device engine."""
    d = _data()
    kw = dict(alpha=2.0, beta=1.0, c=d["c0"])
    c_ep = sharded_gemm(d["a"], d["b"], 9, mesh, **kw)
    c_ep_local = ozt.gemm(d["a"], d["b"], mode="fp64_int8_9", device=mesh_device(mesh), **kw)
    return dict(c_ep=c_ep, c_ep_local=c_ep_local, bitwise=_same_bits(c_ep, c_ep_local))


def zgemm(mesh) -> dict:
    """Distributed ZGEMM: the 4-pass complex engine, int8-only traffic."""
    d = _data()
    z = sharded_gemm(d["za"], d["zb"], 9, mesh)
    z_local = ozt.gemm(d["za"], d["zb"], mode="fp64_int8_9", device=mesh_device(mesh))
    return dict(z=z, z_local=z_local, bitwise=_same_bits(z, z_local))


def ring(mesh) -> dict:
    """The Cannon-streamed variant on a square mesh of 4 ranks: q-fold
    lower peak memory, for problems whose gathered slabs would not fit."""
    import torch.distributed as dist

    if dist.get_world_size() != 4:
        return dict(ran=False)
    d = _data()
    sq = make_mesh_2d(4, device_type=mesh.device_type)
    c_ring = sharded_gemm(d["a"], d["b"], 9, sq, ring=True)
    c_local = ozt.gemm(d["a"], d["b"], mode="fp64_int8_9", device=mesh_device(mesh))
    return dict(ran=True, c_ring=c_ring, bitwise=_same_bits(c_ring, c_local))


def auto_select(mesh) -> dict:
    """Distributed AUTO mode selection: the mesh-wide mantissa-loss
    estimator, the same choice as ``ozt.auto_mode_select``."""
    d = _data()
    sel = sharded_auto_mode_select(d["aw"], d["bw"], mesh)
    single = ozt.auto_mode_select(d["aw"], d["bw"], device=mesh_device(mesh))
    return dict(mode=sel.value, single_device_mode=single.value, same=sel is single)


def auto_gemm(mesh) -> dict:
    """Fully automatic: distributed AUTO plus the variant choice (summa /
    ring / stream / k-sharded)."""
    d = _data()
    c_auto = sharded_gemm_auto(d["aw"], d["bw"], "auto", mesh)
    c_auto_local = ozt.gemm(d["aw"], d["bw"], mode="fp64_int8_auto", device=mesh_device(mesh))
    return dict(c_auto=c_auto, c_auto_local=c_auto_local,
                bitwise=_same_bits(c_auto, c_auto_local))


def tall_k(mesh) -> dict:
    """Tall-contraction complex: routed to the 1-D k-sharded ZGEMM."""
    d = _data()
    zk = sharded_gemm_auto(d["zk_a"], d["zk_b"], 10, mesh)
    zk_local = ozt.gemm(d["zk_a"], d["zk_b"], mode="fp64_int8_10", device=mesh_device(mesh))
    return dict(zk=zk, zk_local=zk_local, bitwise=_same_bits(zk, zk_local))


CASES = {"summa": summa, "epilogue": epilogue, "zgemm": zgemm, "ring": ring,
         "auto_select": auto_select, "auto_gemm": auto_gemm, "tall_k": tall_k}


def main(device="cuda", n=256, backend=None, timeout=600.0) -> dict:
    """The table on 4 ranks of a 2 x 2 mesh; prints and returns rank 0's
    results (case -> dict).  A case that fails on any rank raises."""
    from ozimmu_tpu_torch.parallel import local

    _device(device, 4, backend)
    saved = os.environ.get("OZIMMU_EXAMPLE_N")
    os.environ["OZIMMU_EXAMPLE_N"] = str(n)
    try:
        ranks = local.run(f"{HERE}:CASES", "2x2", nproc=4, device=device, backend=backend,
                          timeout=timeout)
    finally:
        if saved is None:
            del os.environ["OZIMMU_EXAMPLE_N"]
        else:
            os.environ["OZIMMU_EXAMPLE_N"] = saved
    for r, res in enumerate(ranks):
        for key, val in res.items():
            if key.endswith("/error"):
                raise RuntimeError(f"case {key[:-6]} failed on rank {r}:\n{val}")
    out = {name: {k.split("/", 1)[1]: (v.item() if v.ndim == 0 else v)
                  for k, v in ranks[0].items() if k.startswith(name + "/")} for name in CASES}
    print("mesh:", tuple(int(v) for v in out["summa"]["mesh"]),
          "residual:", out["summa"]["residual"])
    print("bitwise == local:", out["summa"]["bitwise"])
    print("epilogue bitwise == local:", out["epilogue"]["bitwise"])
    print("zgemm bitwise == local:", out["zgemm"]["bitwise"])
    if out["ring"]["ran"]:
        print("ring bitwise == local:", out["ring"]["bitwise"])
    else:
        print("ring demo needs a square mesh of 4 ranks")
    print("distributed AUTO picked:", out["auto_select"]["mode"],
          "(single-device picks:", out["auto_select"]["single_device_mode"] + ")")
    print("auto bitwise == local:", out["auto_gemm"]["bitwise"])
    print("tall-k complex == local:", out["tall_k"]["bitwise"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args()
    main(args.device, args.n, args.backend)
