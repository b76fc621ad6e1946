"""Rows answered over the traced serve window by the host clock (the
window's span), under the profiler: ``serve_rows_per_s`` kept per layer,
since on the host's clock alone the untraced rate wanders with the
host's single-thread speed by more than half of any bound it could
take."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace.window_us <= 0 or not ctx.items:
        return None
    return sum(s for _, s in ctx.items) / (ctx.trace.window_us / 1e6)
