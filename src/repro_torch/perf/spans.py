"""Stage spans and counters inside the forest step and snapshot serving.

Both are live only while a ``torch.profiler`` records: with no profiler
a span is one shared ``nullcontext`` and a count is dropped, so the
untraced step pays one check of the profiler's flag for each.

* :func:`span` -- ``record_function(name)``: the profiler records the
  span on the same timeline as the device activity it traces, so every
  idle gap of the device falls inside the stage that was running;
* :func:`count` / :func:`counts` / :func:`reset_counts` -- plain host
  integers at values the step already holds on the host (a compaction's
  row count, a split list's length, a host branch taken, a stage that ran
  its kernel: ``forest.leaf_stats``), so counting adds no launch and no
  device read.

This module imports nothing of the port, so the kernels' wrappers and
the core modules may import it; :mod:`repro_torch.perf.profile`
re-exports it and writes the counters beside its traces.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span", "count", "counts", "reset_counts"]

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_COUNTS: dict = {}


def span(name: str):
    """A context manager that records ``name`` as a span while a profiler
    records, and does nothing otherwise."""
    if _recording():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to counter ``name`` while a profiler
    records."""
    if _recording():
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counts() -> dict:
    """``{name: total}`` of every counter since the last reset."""
    return dict(_COUNTS)


def reset_counts() -> None:
    _COUNTS.clear()
