"""Share of the traced learn window in which no device operation ran:
one minus the union of kernel, copy and memset intervals over the
window's length."""


def read(ctx):
    if ctx.kind != "learn" or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
