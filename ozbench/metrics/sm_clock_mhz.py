"""The median SM clock (``.gemm``, ``.batched``), sampled through NVML
every 0.2 s across the traced run's untraced window (the power draw and
the power limit go to stderr beside it)."""


def read(ctx):
    return ctx.clock_mhz
