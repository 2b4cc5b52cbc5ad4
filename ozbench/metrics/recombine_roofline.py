"""The recombine kernel's share of its roofline (``.gemm``, ``.batched``,
``.hpl``): every slice pair's int8 work at the int8 peak, or the planes
read and the triple-f32 accumulator written at the HBM peak, over the
traced units' engine products (in HPL every step's two products, k =
NB), over the device time of ``csrc/recombine.cu``'s fold kernel."""

from harness import readers, roofline

KERNELS = r"recombine_kernel"


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, roofline.recombine_least_s)
