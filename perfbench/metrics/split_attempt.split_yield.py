"""Share of attempted leaves that split: the program's ``forest.splits``
counter (leaves given two children) over ``forest.attempted_leaves``
(leaves the compacted query scored), in the traced window.  The
profiler records only the window's steps, so the counters hold exactly
the window (``harness/stages.py``).  Nothing when no leaf attempted."""
from harness import stages


def read(ctx):
    if ctx.kind != "learn":
        return None
    c = stages.counters()
    tried = c.get("forest.attempted_leaves", 0)
    return 100.0 * c.get("forest.splits", 0) / tried if tried else None
