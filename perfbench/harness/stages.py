"""The program's own stage spans and counters, as the per-layer readers
see them.

The program records a span at each stage of ``forest.update`` and of
``predict_snapshot`` (``record_function``, so the spans are host events
of the traced window, category ``user_annotation``) and advances its
counters (``repro_torch.perf.profile.counts()``) only while a profiler
records.  In a ``--trace 1`` run the profiler records only the window's
steps: set-up, the kept steps and the judging run with it off, so the
counters hold exactly the window.  A program without spans or counters
gives none here, and the readers then report nothing.
"""
from __future__ import annotations


def counters() -> dict:
    """The program's counters, or ``{}`` where it keeps none."""
    try:
        from repro_torch.perf import profile
    except ImportError:
        return {}
    counts = getattr(profile, "counts", None)
    return counts() if counts is not None else {}


def span_ms(trace, names) -> float:
    """Summed host duration, in ms, of the window's spans named in ``names``."""
    return sum(dur for name, cat, _, dur in trace.host
               if cat == "user_annotation" and name in names) / 1e3
