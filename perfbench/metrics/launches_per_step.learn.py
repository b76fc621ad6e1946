"""Kernels a learned step: the device's kernel records in the traced
window over its steps (every kernel, the port's and PyTorch's)."""


def read(ctx):
    if ctx.kind != "learn" or not ctx.n:
        return None
    return ctx.trace.count_device(("kernel",)) / ctx.n
