"""Device milliseconds a solve in torch's copies (``.zhpl``): its copy
kernel, its kernel of ``torch.complex`` and its device-to-device
``memcpy``.  They are the complex layout of every engine product
(``core/gemm.py``'s ``_planes`` and ``_complex_result``, counted by
``ZLAYOUT_COPIES``), the solver's writebacks into the resident matrix
(``linalg.py``'s ``oz.lu.writeback``) and its copy of A.  The trace keeps
no correlation ids, and these run the same kernels, so they are found
together by the names torch gives them.  The kernel launches matched a
solve go to stderr, to be held against the driver's counts."""

import sys

NAMES = r"direct_copy_kernel_cuda|complex_kernel_cuda|Memcpy DtoD"
CATS = ("kernel", "gpu_memcpy")


def read(ctx):
    if not ctx.trace.device:
        return None
    print(f"[metric] zcopy_ms: {ctx.trace.launches(NAMES) / ctx.units!r} kernel launches a solve",
          file=sys.stderr)
    return 1e3 * ctx.trace.device_seconds(NAMES, cats=CATS) / ctx.units
