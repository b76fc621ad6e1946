#!/usr/bin/env python3
"""Time routing, serving, a learned step's launches and host syncs, and the
single-table split query of one or more checkouts of this repository on one
NVIDIA GPU, in the order given.

    python3 tools_torch/ab_route_query.py TREE [TREE ...] [--seed N]

Each TREE is the root of a checkout; its ``src/`` is imported in a process
of its own, so two versions of ``repro_torch`` never meet.  The shapes, the
forest's configuration and stream, and the timers are those of this
checkout's ``chip_smoke.py`` (imported from it).  Give a parent and a
change in turns (parent, change, change, parent) to compare them on one
card.  Each run prints one JSON line, with the card's name and power
limit, holding (all times in ms):

* ``route_call_ms`` / ``route_device_ms`` / ``route_device_ops``: the learn
  path's route call (``forest._route_all``, with whatever host work it
  does) on the QO forest after 8 learned batches (``chip_smoke.py`` phase
  3) and after 16 (the end of its phase-7 window), with the next batch's
  rows: the median CUDA-event time of a call, the profiler's device time
  of a call and the device operations a call runs;
* ``step_ms``, ``launches_per_step``, ``syncs_per_step``,
  ``route_kernel_device_ms``: phase 7's window (8 steps after 8 warm-up
  batches): wall time a step unprofiled; ``cudaLaunchKernel`` and
  ``cudaStreamSynchronize`` a step and the route kernel's device time a
  launch under torch.profiler;
* ``serve_ms``: ``predict_snapshot`` of phase 6's request on the forest
  after all of the stream's batches;
* ``query_call_ms`` / ``query_device_ms``: ``qo_query.best_kernel`` on a
  C = 1,024 table holding one 10^6-row paper stream.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(tree: str, seed: int) -> dict:
    """Every measurement of one checkout, in this process."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    # after chip_smoke, which puts this checkout's src/ first
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import forest as fr
    from repro_torch.core import qo
    from repro_torch.core import serve as sv
    from repro_torch.data import synth
    from repro_torch.kernels import _build, qo_query

    if not torch.cuda.is_available():
        raise SystemExit("ab_route_query: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    _build.build()
    cfg = cs.forest_config()
    batches = cs.stream_batches(seed, dev)
    warm, window = cs.WARM_BATCHES, 8
    out = {"tree": tree}

    def learn(st, lo, hi):
        for Xb, yb in batches[lo:hi]:
            st, _ = fr.update(cfg, st, Xb, yb, device=dev)
        torch.cuda.synchronize()
        return st

    def route_at(st, n_learned, tag):
        Xk = batches[n_learned][0]
        call = lambda: fr._route_all(cfg, st["trees"], Xk)
        out[f"route_call_ms_{tag}"] = cs._time_ms(call)
        out[f"route_device_ms_{tag}"] = cs._device_ms(call)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        out[f"route_device_ops_{tag}"] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 10

    state = learn(fr.init_forest(cfg, seed, device=dev), 0, warm)
    route_at(state, warm, "phase3")
    t0 = time.perf_counter()
    state = learn(state, warm, warm + window)
    out["step_ms"] = (time.perf_counter() - t0) / window * 1e3
    route_at(state, warm + window, "phase7_end")

    state = learn(fr.init_forest(cfg, seed, device=dev), 0, warm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = learn(state, warm, warm + window)
    ev = prof.key_averages()
    host = {e.key: e.count for e in ev}
    out["launches_per_step"] = host.get("cudaLaunchKernel", 0) / window
    out["syncs_per_step"] = host.get("cudaStreamSynchronize", 0) / window
    route = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
             and "qo_route" in e.key]
    out["route_kernel_device_ms"] = (
        sum(e.self_device_time_total for e in route) / 1e3
        / max(sum(e.count for e in route), 1))
    out["route_kernel_launches_per_step"] = \
        sum(e.count for e in route) / window

    state = learn(state, warm + window, len(batches))
    snap = sv.freeze(state, device=dev)
    Xs, _ = synth.piecewise_regression(cs.SERVE_ROWS, cs.F, seed=seed + 7)
    Xs = torch.as_tensor(Xs, device=dev)
    out["serve_ms"] = cs._time_ms(lambda: sv.predict_snapshot(snap, Xs,
                                                              device=dev))
    del state, snap

    x, y = cs._paper_stream(synth.SynthConfig(noise_frac=0.1, n=cs.QO_ROWS,
                                              seed=seed), dev)
    r, o = qo.auto_radius(x, k=2.0)
    table = qo.update(qo.init(cs.QO_BINS, r, o, device=dev), x, y,
                      device=dev)
    planes = [a.contiguous() for a in cs._qo_planes(table)]
    query = lambda: qo_query.best_kernel(*planes)
    out["query_call_ms"] = cs._time_ms(query)
    out["query_device_ms"] = cs._device_ms(query)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.seed)), flush=True)
        return 0
    if not args.trees:
        ap.error("name at least one checkout")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for tree in args.trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, "--seed", str(args.seed)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["card"] = smi
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
