"""A profiled window and what the per-layer readers read from it.

:func:`profile` runs a block under ``torch.profiler`` (host and device
activity) inside a ``perfbench.window`` span, exports the Chrome trace to
the run's temporary directory, reads it back and deletes it.  The
:class:`Trace` it returns holds the device events (kernels, copies,
memsets) and the host events (operators and CUDA runtime calls) that
fall inside the window, with the window's length and the device's busy
time (the union of device intervals).
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: Host calls that wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize")


@dataclass
class Trace:
    window_us: float
    device: list = field(default_factory=list)   # (name, cat, ts, dur), window-relative us
    host: list = field(default_factory=list)     # (name, cat, ts, dur)

    def busy_intervals(self):
        """Merged (start, end) device intervals, in us from the window's start."""
        iv = sorted((ts, ts + dur) for _, _, ts, dur in self.device)
        out = []
        for s, e in iv:
            s, e = max(s, 0.0), min(e, self.window_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_us(self):
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_us(self, prefixes):
        """Device time of the kernels whose name starts with a prefix."""
        return sum(dur for name, cat, _, dur in self.device
                   if cat == "kernel" and kernel_name(name).startswith(prefixes))

    def count_device(self, cats=("kernel",)):
        return sum(1 for _, cat, _, _ in self.device if cat in cats)

    def count_host(self, names):
        return sum(1 for name, cat, _, _ in self.host
                   if cat in ("cuda_runtime", "cuda_driver") and name in names)

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        gaps summed by the host event running at their midpoint."""
        ops = {}
        for name, _, _, dur in self.device:
            key = kernel_name(name)[:120]
            ops[key] = ops.get(key, 0.0) + dur
        device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [0.0] + [x for iv in busy for x in iv] + [self.window_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        if not gaps:
            return {"device_ops": [[k, v / 1e6] for k, v in device_ops], "idle_gaps": []}
        mids = np.array([(s + e) / 2 for s, e in gaps])
        order = np.argsort(mids)
        mids = mids[order]
        label = np.full(len(mids), -1)
        hosts = [h for h in self.host if h[0] != WINDOW]
        names = [h[0] for h in hosts]
        for i in sorted(range(len(hosts)), key=lambda i: -hosts[i][3]):
            _, _, ts, dur = hosts[i]
            lo, hi = np.searchsorted(mids, ts), np.searchsorted(mids, ts + dur)
            label[lo:hi] = i
        sums = {}
        for j, gi in enumerate(order):
            s, e = gaps[gi]
            key = names[label[j]][:120] if label[j] >= 0 else "host outside any operator"
            sums[key] = sums.get(key, 0.0) + (e - s)
        idle = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v / 1e6] for k, v in device_ops],
                "idle_gaps": [[k, v / 1e6] for k, v in idle]}


def kernel_name(name):
    return name[5:] if name.startswith("void ") else name


def parse(events):
    """A :class:`Trace` from Chrome-trace events (the window's span must be
    among them)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tr = Trace(window_us=w1 - w0)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur, cat = float(e["ts"]), float(e["dur"]), e.get("cat", "")
        if ts + dur < w0 or ts > w1:
            continue
        item = (e.get("name", ""), cat, ts - w0, dur)
        if cat in DEVICE_CATS:
            tr.device.append(item)
        elif cat in HOST_CATS:
            tr.host.append(item)
    return tr


def profile(block):
    """Run ``block()`` profiled; the block ends with a device sync."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            block()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)
