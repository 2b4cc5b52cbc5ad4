"""The distributed layer on ``torch.distributed``: the port of
``ozimmu_tpu.parallel``.

SUMMA (:func:`sharded_gemm`), the k-sharded variant
(:func:`sharded_gemm_k`), the Cannon ring and the streamed SUMMA
(``variant="ring"`` / ``"stream"``), real and complex, distributed AUTO
(:func:`sharded_gemm_auto`) and the pre-sharded entries, over a
``DeviceMesh``; the CUDA split and recombine kernels run inside every
rank (SUMMA folds in the recombine kernel; the ring, stream and k-sharded
variants sum int32 group totals through its totals mode, then one
totals-fold launch).  Launch with ``torchrun`` (each rank calls :func:`initialize`) or,
on one host, ``python -m ozimmu_tpu_torch.parallel.local``.
"""

from .gemm import (
    k_device_bytes,
    make_mesh_2d,
    ring_device_bytes,
    select_variant,
    sharded_auto_mode_select,
    sharded_dgemm_native_fn,
    sharded_gemm,
    sharded_gemm_auto,
    sharded_gemm_fn,
    sharded_gemm_k,
    sharded_gemm_k_fn,
    sharded_gemm_presharded,
    sharded_gemm_ring_fn,
    sharded_gemm_stream_fn,
    sharded_loss_totals_fn,
    sharded_zgemm_fn,
    sharded_zgemm_k_fn,
    sharded_zgemm_presharded,
    sharded_zgemm_ring_fn,
    sharded_zgemm_stream_fn,
    sharded_zloss_totals_fn,
    stream_device_bytes,
    summa_device_bytes,
)
from .launch import (
    allgather_f64x,
    dcn_axis_for,
    initialize,
    make_mesh_2d_hybrid,
    replicated_f64x,
    shard_local_f64x,
)

__all__ = [
    "allgather_f64x",
    "dcn_axis_for",
    "initialize",
    "k_device_bytes",
    "make_mesh_2d",
    "make_mesh_2d_hybrid",
    "replicated_f64x",
    "ring_device_bytes",
    "select_variant",
    "shard_local_f64x",
    "sharded_auto_mode_select",
    "sharded_dgemm_native_fn",
    "sharded_gemm",
    "sharded_gemm_auto",
    "sharded_gemm_fn",
    "sharded_gemm_k",
    "sharded_gemm_k_fn",
    "sharded_gemm_presharded",
    "sharded_gemm_ring_fn",
    "sharded_gemm_stream_fn",
    "sharded_loss_totals_fn",
    "sharded_zgemm_fn",
    "sharded_zgemm_k_fn",
    "sharded_zgemm_presharded",
    "sharded_zgemm_ring_fn",
    "sharded_zgemm_stream_fn",
    "sharded_zloss_totals_fn",
    "stream_device_bytes",
    "summa_device_bytes",
]
