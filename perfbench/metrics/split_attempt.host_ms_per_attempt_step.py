"""Host time of the whole split attempt a step that attempts one: the
summed durations of the program's ``forest.query`` (the sketch's slot
sort, the compaction and the batched query), ``forest.decide`` and
``forest.apply`` spans in the traced window over its
``forest.attempt_steps`` counter (steps on which some leaf was due and
its tree had room).  The spans' host time includes the host's waits for
the device inside them (the compaction's and the split list's
``torch.nonzero``).  The profiler records only the window's steps, so
the counter holds exactly the window (``harness/stages.py``).  Nothing
when no step attempted."""
from harness import stages

SPANS = ("forest.query", "forest.decide", "forest.apply")


def read(ctx):
    if ctx.kind != "learn":
        return None
    steps = stages.counters().get("forest.attempt_steps", 0)
    ms = stages.span_ms(ctx.trace, SPANS)
    return ms / steps if steps and ms > 0 else None
