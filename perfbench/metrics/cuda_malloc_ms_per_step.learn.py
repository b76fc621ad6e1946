"""Host time in the CUDA allocator's runtime calls a learned step: the
summed durations of the traced window's ``cudaMalloc`` and ``cudaFree``
runtime events (host-side calls, which block the step while they run)
over the program's ``forest.steps`` counter.  The traced window is the
steps that follow set-up and the kept steps, so this reads the
allocator's time early in a run, while the caching allocator still
grows.  Nothing when the program keeps no step counter."""
from harness import stages

CALLS = ("cudaMalloc", "cudaFree")


def read(ctx):
    if ctx.kind != "learn":
        return None
    steps = stages.counters().get("forest.steps", 0)
    if not steps:
        return None
    us = sum(dur for name, cat, _, dur in ctx.trace.host
             if cat == "cuda_runtime" and name in CALLS)
    return us / 1e3 / steps
