"""Host time of a drift swap: the summed durations of the program's
``forest.swap`` spans (fresh member tables, the selects that put them in
place, the new subspace masks) in the traced window over its
``forest.swaps`` counter (steps whose drift test swapped a member).  The
profiler records only the window's steps, so the counter holds exactly
the window (``harness/stages.py``).  Nothing when the window swapped no
member."""
from harness import stages


def read(ctx):
    if ctx.kind != "learn":
        return None
    swaps = stages.counters().get("forest.swaps", 0)
    ms = stages.span_ms(ctx.trace, ("forest.swap",))
    return ms / swaps if swaps and ms > 0 else None
