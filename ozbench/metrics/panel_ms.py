"""Device milliseconds per solve in the operations of the libraries that
the solver calls (``.hpl``): cuSOLVER's panels, cuBLAS's triangular
solves and GEMMs, torch's copies and row swaps.  The port's own kernels
are left out by name and, whatever their name, by the anonymous
namespace that every kernel of ``ozimmu_tpu_torch/csrc`` is defined in,
so a renamed kernel of the port is not counted as the panels' time."""

#: the program's own kernels (``ozimmu_tpu_torch/csrc``)
PORT_KERNELS = r"\(anonymous namespace\)::|recombine_kernel|totals_fold_kernel" \
               r"|split_(rows|tiles)_kernel|exponent_(rows|cols)_kernel|epilogue_kernel|zfold_kernel"


def read(ctx):
    if not ctx.trace.device:
        return None
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    return 1e3 * ctx.trace.device_seconds(exclude=PORT_KERNELS, cats=cats) / ctx.units
