"""Profiler traces, per-op costs and per-kernel device time.

The counterpart of the reference's ``repro.perf.profile``:

* :func:`trace` -- ``torch.profiler`` around a block, written as a Chrome
  trace (Perfetto, ``chrome://tracing``) into a directory, with the
  block's stage counters beside it;
* :func:`span`, :func:`count`, :func:`counts` -- the stage spans and
  counters inside the port (:mod:`repro_torch.perf.spans`), live only
  while a profiler records;
* :func:`op_costs` -- flops and bytes of one call counted by
  :mod:`repro_torch.perf.opcost`, the peak device memory, and the least
  time the card could take for the counted work (:func:`bound`: bytes
  over the H100's HBM rate, flops over its float32 rate, the larger);
* :func:`profile_ops` / :func:`write_report` -- :func:`op_costs` of a
  named set of calls, optionally traced, as JSON;
* :func:`device_times` -- the device time of one call, by kernel name.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity) at
its full 700 W: 3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the
tensor cores, 989 TFLOP/s of dense bf16 on the tensor cores and 450 GB/s
of NVLink 4 a direction (the dry-run's roofline terms).  A card set below 700 W (``nvidia-smi``'s ``power.limit``)
runs slower; state its limit beside any share of these.

Reading a live forest.  Under :func:`trace`, every ``forest.update``
records its stages as nested spans (``forest.predict``, ``forest.bag``,
``forest.route``, ``forest.stats``, ``forest.absorb``, ``forest.attempt``
with its children ``forest.query``, ``forest.decide`` and
``forest.apply`` on the steps that attempt a split, ``forest.drift``,
``forest.swap`` on the steps that swap a member, ``forest.vote``), and
every ``predict_snapshot`` records ``serve.predict_snapshot`` with
``serve.h2d``, ``serve.route`` and ``serve.vote``.  The counters file
``counters_<pid>_<n>.json`` written beside ``trace_<pid>_<n>.json``
holds the block's ``forest.steps``, ``forest.attempt_steps``,
``forest.attempted_leaves``, ``forest.splits``, ``forest.swaps``,
``serve.requests`` and ``serve.rows``: from them, the share of attempted
leaves that split and the swaps a step; from the trace, each stage's
host time and the device's idle gaps inside it.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os

import torch

from repro_torch.perf import opcost
from repro_torch.perf.spans import count, counts, reset_counts, span

__all__ = ["trace", "span", "count", "counts", "reset_counts", "op_costs",
           "profile_ops", "write_report", "device_times", "device_events",
           "bound", "HBM_BYTES_PER_S", "FP32_FLOPS", "BF16_FLOPS",
           "NVLINK_BYTES_PER_S"]

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
NVLINK_BYTES_PER_S = 450e9     # H100 SXM data sheet, NVLink 4 a direction

_TRACES = itertools.count()


def bound(nbytes: float, flops: float):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``nbytes`` and do ``flops`` float32 operations, and which of
    the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (host ops, and device kernels when a card
    is visible) and write it as ``trace_<pid>_<n>.json`` into ``logdir``
    (created if missing), and the block's counters (:func:`counts`, reset
    on entry) as ``counters_<pid>_<n>.json`` beside it.  Yields the
    directory.

    Keep the block BOUNDED -- a handful of steps, not a benchmark run: the
    profiler holds every event in host memory until the block ends, so
    minutes of launches (e.g. the tuner's race) exhaust memory instead of
    giving a trace.  :func:`profile_ops` with ``logdir`` is the packaged
    form."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_counts()
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    stem = f"{os.getpid()}_{next(_TRACES)}.json"
    prof.export_chrome_trace(os.path.join(logdir, "trace_" + stem))
    with open(os.path.join(logdir, "counters_" + stem), "w") as f:
        json.dump(counts(), f, indent=1, sort_keys=True)


def op_costs(fn, *args) -> dict:
    """Run ``fn(*args)`` once and return ``{"flops", "bytes",
    "peak_memory", "optimal_seconds"}``: flops and bytes counted by
    :class:`repro_torch.perf.opcost.OpCounter` (the port's kernels
    included); where the call ran on the card, its peak device memory
    (``torch.cuda.max_memory_allocated`` after a reset) and
    ``max(bytes / HBM rate, flops / float32 rate)``; 0.0 for both on the
    CPU.

    ``optimal_seconds`` is the floor of the COUNTED work.  The counts
    follow the data where a kernel's cost reads it (the leaves a batch
    reached, the nodes a forest allocated, a tree's size) and the
    launch's shapes elsewhere: a route's compares are counted at its ply
    bound, an upper bound on its flops (at the forest's shapes its bytes,
    not its flops, set its floor).  Counting reads those values from the card, so the call
    under count is not a timed one."""
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counter = opcost.count(fn, *args)
    out = {"flops": float(counter.flops), "bytes": float(counter.bytes),
           "peak_memory": 0.0, "optimal_seconds": 0.0}
    if on_card and "cuda" in counter.devices:
        torch.cuda.synchronize()
        out["peak_memory"] = float(torch.cuda.max_memory_allocated())
        out["optimal_seconds"] = bound(out["bytes"], out["flops"])[0] / 1e3
    return out


def profile_ops(named: dict, *, logdir: str | None = None) -> dict:
    """:func:`op_costs` of ``{name: (fn, args)}``; with ``logdir``, each
    op also runs once more under one :func:`trace`.  Returns ``{name:
    costs}``."""
    report = {name: op_costs(fn, *args) for name, (fn, args) in named.items()}
    if logdir is not None:
        with trace(logdir):
            for fn, args in named.values():
                fn(*args)
    return report


def write_report(report: dict, path: str) -> str:
    """Write a :func:`profile_ops` report as JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    return path


def device_events(prof) -> list:
    """The device-side events (kernels, copies) of a finished profiler's
    ``key_averages()``: an ATen op's own device time repeats the time of
    the kernels it launched, so only these are summed."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_times(fn, reps: int = 10, warm: bool = True) -> dict:
    """``{kernel name: device ms a call}`` of ``fn`` over ``reps`` calls
    under ``torch.profiler`` (after one warm-up call unless ``warm`` is
    false).  A window in which the profiler recorded fewer device events
    than calls (it can drop a window's activity) is profiled again, up to
    three times; ``{}`` if all three dropped."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if sum(e.count for e in events) >= reps:
            times = {}
            for e in events:
                times[e.key] = times.get(e.key, 0.0) \
                    + e.self_device_time_total / 1e3 / reps
            return times
    return {}
