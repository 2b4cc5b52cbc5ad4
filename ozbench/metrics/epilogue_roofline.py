"""The epilogue's share of its roofline (``.gemm``, ``.batched``): the
triple-f32 accumulator read (12 B an element) and the output written (8 B)
with the exponents, at the HBM peak, over the device time of
``csrc/epilogue.cu``'s epilogue kernel."""

from harness import readers, roofline

KERNELS = r"epilogue_kernel"


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, roofline.epilogue_least_s)
