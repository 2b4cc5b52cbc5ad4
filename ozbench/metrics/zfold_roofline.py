"""The complex fold's share of its roofline (``.complex``): the four
passes' triple-f32 accumulators read (4 × 12 B an element), C0 read
(16 B, where beta is set) and the complex output written (16 B), with
the four passes' exponents, at the HBM peak, over the device time of
``csrc/epilogue.cu``'s ``zfold_kernel`` (``harness/zroofline.py``)."""

from harness import readers, zroofline

KERNELS = r"zfold_kernel"


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, zroofline.zfold_least_s)
