"""The complex split's share of its roofline (``.complex``): A's and B's
real and imaginary parts each read once (8 B an element) and their planes
written once (ns B an element), with 4 B of exponents a row of each A
part and a column of each B part, at the HBM peak, over the device time
of ``csrc/exponent.cu``'s and ``csrc/split.cu``'s kernels.  The four
passes share the four parts' splits, so each part is counted once
(``harness/zroofline.py``)."""

from harness import readers, zroofline

KERNELS = r"exponent_(rows|cols)_kernel|split_(rows|tiles)_kernel"


def read(ctx):
    return readers.roofline_share(ctx, KERNELS, zroofline.zsplit_least_s)
