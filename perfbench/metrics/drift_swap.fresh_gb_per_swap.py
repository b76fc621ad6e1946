"""Fresh member state a drift swap builds: the program's
``forest.fresh_bytes`` counter (the bytes of the fresh members' tables,
counts and masks that a swap allocates before it selects the drifting
member's) over its ``forest.swaps`` counter, in GB (1e9 bytes).  The
profiler records only the window's steps, so the counters hold exactly
the window (``harness/stages.py``).  Nothing when the window swapped no
member or the program keeps no such counter."""
from harness import stages


def read(ctx):
    if ctx.kind != "learn":
        return None
    c = stages.counters()
    swaps, nbytes = c.get("forest.swaps", 0), c.get("forest.fresh_bytes")
    return nbytes / swaps / 1e9 if swaps and nbytes is not None else None
