"""The split's share of its roofline (``.gemm``, ``.batched``): both
operands read once (8 B an element), their planes written once (ns B an
element) and the exponents, at the HBM peak, over the device time of
``csrc/exponent.cu``'s and ``csrc/split.cu``'s kernels."""

from harness import readers, roofline

KERNELS = r"exponent_(rows|cols)_kernel|split_(rows|tiles)_kernel"


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, roofline.split_least_s)
