"""Device operations a served request: kernels, copies and memsets in
the traced window over its requests."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.n:
        return None
    return ctx.trace.count_device(("kernel", "gpu_memcpy", "gpu_memset")) / ctx.n
