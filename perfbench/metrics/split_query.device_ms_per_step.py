"""Device time of the split query a learned step: the kernels named
``qo_query_batched*`` (the compacted query over the attempting tables)
in the traced window over its steps.  The stages around it (the
compaction's ``torch.nonzero``, under the sketch the slot sort) run
PyTorch kernels whose names other stages share, so they are not in it."""


def read(ctx):
    if ctx.kind != "learn" or not ctx.n:
        return None
    us = ctx.trace.kernel_us(("qo_query_batched",))
    return us / 1e3 / ctx.n if us > 0 else None
