"""Per cent of the traced window in which the device runs nothing
(``.gemm``, ``.batched``, ``.hpl``, ``.call``)."""


def read(ctx):
    return ctx.trace.idle_share()
