"""A serve cell: one closed-loop caller sends ``predict_snapshot``
requests to a snapshot frozen in set-up, each request a host numpy array
cut from a host pool, each answer brought back to the host before the
next request.

Set-up learns ``warm_batches`` batches of the traffic's stream through
``forest.update`` (as a learn cell's set-up does, ``learn.Loop``), freezes
the forest with ``serve.freeze``, copies the request pool to the host and serves one
request of each size class once.  Request sizes are the traffic's fixed
multiset in an order drawn from the seed.  Every ``check_every``-th
request, from an offset drawn from the seed, and the window's first
request of the largest size keep their answers; once the window has
closed they are judged against the reference's vote over the live trees
the snapshot was frozen from, and those trees are judged by the carried
comparison (``learn.carry``): the program learns the same batches again
beside a forest the reference carries itself, and the state it reaches
is compared bit for bit with the one the snapshot was frozen from.
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from harness import check, learn, port, streams, trace as tracing
from reference import arf


def run(cell, seed, seconds, traced, device, t_proc, control=None):
    cfg, traffic = cell.config, cell.traffic
    loop = learn.Loop(cell, seed, device)
    for _ in range(traffic["warm_batches"]):
        loop.step()
    state = loop.state
    snap = port.freeze(state, device)
    Xh = streams.request_pool(cfg, traffic, seed, device)
    sizes = streams.request_rows(traffic, seed)
    rng = np.random.default_rng(int(seed) + 1)
    offsets = rng.integers(0, Xh.shape[0] - sizes + 1)
    big = int(sizes.max())
    for s in sorted({1 << b for b in range(big.bit_length())} | {big}):
        port.predict_snapshot(snap, Xh[:s], device).cpu().numpy()
    every = traffic["check_every"]
    first = int(rng.integers(0, every))
    kept, times, items = [], [], []
    L = len(sizes)

    def serve_one(j, keep):
        s, o = int(sizes[j % L]), int(offsets[j % L])
        t0 = time.perf_counter()
        ans = port.predict_snapshot(snap, Xh[o:o + s], device).cpu().numpy()
        times.append(time.perf_counter() - t0)
        if keep:
            kept.append((o, s, ans))

    j, saw_big = 0, False
    gc.collect()
    gc.freeze()
    if not traced:
        setup_s = time.time() - t_proc
        t_start = time.perf_counter()
        while True:
            s = int(sizes[j % L])
            keep = j % every == first or (s == big and not saw_big)
            saw_big |= s == big
            serve_one(j, keep)
            j += 1
            if time.perf_counter() - t_start >= seconds:
                break
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_start
        tr = None
    else:
        # the kept requests come before the traced window
        for j in range(traffic["trace_checks"]):
            serve_one(j * every + first, True)
        setup_s = time.time() - t_proc
        n = traffic["trace_requests"]

        def block():
            for j in range(n):
                items.append((int(offsets[j % L]), int(sizes[j % L])))
                serve_one(j, False)
        tr = tracing.profile(block)
        j, wall = n, tr.window_us / 1e6
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    readings = judge(cfg, state, Xh, kept, device)
    if control is not None:
        control.extend(judge(cfg, state, Xh, kept, device, torch.bfloat16))
    carried, info, final = learn.carry(loop, seed, traffic["carry_steps"], control)
    info["start_equal"] = check.states_equal(final, state)
    del final
    readings += carried
    out = {"attempted": j, "wall_s": wall, "setup_s": setup_s,
           "memory_peak_bytes": peak, "readings": readings, "carried": info,
           "trace": tr}
    if not traced:
        out["e2e"] = {"serve_p99_ms": float(np.percentile(times, 99)) * 1e3,
                      "setup_s": setup_s}
    else:
        out["ctx"] = types.SimpleNamespace(
            kind="serve", cfg=cfg, traffic=traffic, trace=tr, n=j, items=items,
            snapshot=snap, requests=Xh, device=device)
    return out


def judge(cfg, state, Xh, kept, device, control_dt=None):
    """serve_err of each kept request against the reference; with
    ``control_dt``, of the reference computed in that dtype in the
    program's place (the control) instead."""
    out = []
    for o, s, ans in kept:
        X = torch.as_tensor(Xh[o:o + s], device=device)
        ref = arf.serve(cfg, state, X).float()
        if control_dt is not None:
            ans = arf.serve(cfg, state, X, control_dt).float()
        out.append({"serve_err": check.serve_err(torch.as_tensor(ans, device=device), ref),
                    "rows": s})
    return out
