"""Host waits for the device a learned step: CUDA runtime calls that
block (stream, device and event synchronizes, synchronous copies) in
the traced window over its steps.  The harness's own read of each
step's prequential error is one of them."""
from harness.trace import SYNC_CALLS


def read(ctx):
    if ctx.kind != "learn" or not ctx.n:
        return None
    return ctx.trace.count_host(SYNC_CALLS) / ctx.n
