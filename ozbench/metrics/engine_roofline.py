"""The whole engine's share of the GEMM's roofline (``.gemm``,
``.batched``): the product's int8 work at the int8 peak, or A and B read
and C written once at the HBM peak, over the device time of every kernel
in the traced calls.  It reads the same work whatever kernels do it, so
it survives a fusion."""

from harness import readers, roofline

KERNELS = r""


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, roofline.engine_least_s)
