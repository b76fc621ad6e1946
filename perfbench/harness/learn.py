"""A learn cell: one closed-loop caller feeds the forest batch after batch
(test-then-train), each step one ``forest.update`` whose prequential
error is read back to the host before the next batch is handed over.

Set-up draws the pool (``streams.learn_pool``), builds the forest and
learns ``warm_batches`` batches through the same call.  The window then
cycles the pool from there for ``--seconds``.

Two comparisons judge it once the window has closed (``judge``):

* the carried comparison: the program is run again from an empty forest
  through the pool's first ``carry_steps`` batches (the set-up's and the
  window's first steps), and the reference carries a forest of its own
  beside it, judging every step and taking over only rounding-level
  choices and values (``check.compare_step``, ``check.adopt_rounding``).
  The program is deterministic, so this run is the set-up and the start
  of the window over again: the state it reaches at the window's start,
  and the prequential error of each window step it covers, are compared
  bit for bit with the window's own and reported;
* window steps: some window steps, drawn from the seed, keep a copy of
  the state before and after them and are judged against the reference
  from that pre-step state (``check_every`` apart, a step count coprime
  to the drift's period, and on a drifting stream the first step of each
  of ``change_checks`` consecutive concept changes, where the drift test
  swaps members: at most changes it swaps one at that step).
"""
from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from harness import check, port, streams, trace as tracing
from reference import arf


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The forest, its pool and the position in the pool."""

    def __init__(self, cell, seed, device):
        self.cfg, self.traffic, self.device = cell.config, cell.traffic, device
        self.fcfg = port.forest_config(self.cfg)
        self.pool = streams.learn_pool(self.cfg, self.traffic, seed, device)
        self.P = self.pool["X"].shape[0]
        self.state = port.init(self.fcfg, seed, self.pool["mask0"], device)
        self.pos = 0

    def batch(self, i):
        p = self.pool
        i %= self.P
        return p["X"][i], p["y"][i], p["bag_w"][i], p["masks"][i]

    def step(self):
        """One step on the next batch; returns (step index, aux, seconds,
        forest_mse)."""
        i = self.pos
        X, y, bw, nm = self.batch(i)
        t0 = time.perf_counter()
        self.state, aux = port.update(self.fcfg, self.state, X, y, bw, nm, self.device)
        mse = float(aux["forest_mse"])
        dt = time.perf_counter() - t0
        self.pos += 1
        return i, aux, dt, mse

    def checked_step(self):
        """A step that keeps the states around it for the comparison."""
        pre = port.clone(self.state)
        i, aux, dt, mse = self.step()
        return {"i": i, "pre": pre, "post": port.clone(self.state),
                "aux": {k: v.clone() for k, v in aux.items()}}, dt, mse


def window_checks(traffic, seed):
    """The window steps (0 = the window's first) that keep their states:
    ``max_checks`` steps ``check_every`` apart from an offset drawn from
    the seed, and on a drifting stream the first step of each of
    ``change_checks`` consecutive concept changes past the carried
    comparison's reach, the first of them drawn from the seed."""
    rng = np.random.default_rng(int(seed))
    every = traffic["check_every"]
    first = int(rng.integers(0, every))
    due = {first + j * every for j in range(traffic["max_checks"])}
    if traffic["drift"] != "none":
        per, warm = traffic["period_batches"], traffic["warm_batches"]
        c0 = -(-traffic["carry_steps"] // per) + int(rng.integers(0, 3))
        for c in range(c0, c0 + traffic["change_checks"]):
            due.add(c * per - warm)
    return due


def carry(loop, seed, steps, control=None, window=None):
    """The carried comparison over the pool's first ``steps`` batches.

    ``window``: ``(start_state, mses)``, the program's state at the
    window's start (after ``warm_batches`` steps) and the window's first
    steps' forest errors, to compare the rerun with.  Returns
    ``(readings, info, final program state)``."""
    cfg, dev = loop.cfg, loop.device
    warm = loop.traffic.get("warm_batches", steps)
    prog = port.init(loop.fcfg, seed, loop.pool["mask0"], dev)
    mine = arf.init_forest(cfg, loop.pool["mask0"], dev)
    fp, fm = check._flat(prog), check._flat(mine)
    init_mm = int(set(fp) != set(fm)) + sum(int((fp[k] != fm[k]).sum()) for k in fm)
    out = []
    info = {"carried": steps, "start_equal": None, "window_steps_equal": 0,
            "window_steps_compared": 0}
    every = max(1, steps // 16)
    for s in range(steps):
        if window is not None and s == warm:
            info["start_equal"] = check.states_equal(prog, window[0])
        X, y, bw, nm = loop.batch(s)
        pre = port.clone(prog)
        prog, aux = port.update(loop.fcfg, prog, X, y, bw, nm, dev)
        if window is not None and warm <= s < warm + len(window[1]):
            info["window_steps_compared"] += 1
            info["window_steps_equal"] += float(aux["forest_mse"]) == window[1][s - warm]
        leaf = port.route(pre, X, cfg["max_depth"])
        r, mine = check.compare_step(cfg, mine, pre, prog, aux, X, y, bw, nm, leaf)
        mine = check.adopt_rounding(mine, prog)
        r["choice_mismatch"] += init_mm
        init_mm = 0
        out.append(dict(r, step="carried", s=s))
        if control is not None and s % every == 0:
            control.append(dict(check.control_step(cfg, pre, X, y, bw, nm),
                                step="carried"))
        del pre
    return out, info, prog


def judge(loop, seed, checks, control=None, window=None):
    """Judge the kept window steps and the carried comparison.  Returns
    (readings of each judged step, carried info); with a list
    ``control``, the control's readings on the same steps are appended
    to it."""
    cfg = loop.cfg
    out = []
    for c in checks:
        X, y, bw, nm = loop.batch(c["i"])
        leaf = port.route(c["pre"], X, cfg["max_depth"])
        r, _ = check.compare_step(cfg, c["pre"], c["pre"], c["post"], c["aux"],
                                  X, y, bw, nm, leaf)
        out.append(dict(r, step="window", s=c["i"]))
        if control is not None:
            control.append(dict(check.control_step(cfg, c["pre"], X, y, bw, nm),
                                step="window"))
    checks.clear()
    carried, info, _ = carry(loop, seed, loop.traffic["carry_steps"], control, window)
    return out + carried, info


def run(cell, seed, seconds, traced, device, t_proc, control=None):
    """Set up, run the window, judge it.  Returns a dict for the result.
    ``control``: see :func:`judge`."""
    loop = Loop(cell, seed, device)
    warm = loop.traffic["warm_batches"]
    for _ in range(warm):
        loop.step()
    _sync(device)
    start = port.clone(loop.state)
    n_fp = max(0, loop.traffic["carry_steps"] - warm)
    mses = []
    checks, times, items = [], [], []
    B = loop.cfg["batch_rows"]
    gc.collect()
    gc.freeze()
    if not traced:
        due = window_checks(loop.traffic, seed)
        setup_s = time.time() - t_proc
        t_start = time.perf_counter()
        k = 0
        while True:
            if k in due:
                c, dt, mse = loop.checked_step()
                checks.append(c)
            else:
                dt, mse = loop.step()[2:]
            times.append(dt)
            if k < n_fp:
                mses.append(mse)
            k += 1
            if time.perf_counter() - t_start >= seconds:
                break
        _sync(device)
        wall = time.perf_counter() - t_start
        tr = None
    else:
        # the kept steps come before the traced window, so their copies
        # stay out of the trace
        for j in range(loop.traffic["trace_checks"]):
            c, _, mse = loop.checked_step()
            checks.append(c)
            mses.append(mse)
            mses.append(loop.step()[3])
        _sync(device)
        setup_s = time.time() - t_proc
        n = loop.traffic["trace_steps"]

        def block():
            for _ in range(n):
                t = loop.state["trees"]
                pre = {k: t[k] for k in ("feature", "threshold", "child", "is_leaf",
                                         "n_nodes")}
                i, _, _, mse = loop.step()
                mses.append(mse)
                items.append({"i": i, "trees": pre})
        tr = tracing.profile(block)
        k, wall = n, tr.window_us / 1e6
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    loop.state = None
    readings, info = judge(loop, seed, checks, control, (start, mses[:n_fp]))
    out = {"attempted": k, "wall_s": wall, "setup_s": setup_s, "memory_peak_bytes": peak,
           "readings": readings, "carried": info, "trace": tr}
    if not traced:
        out["e2e"] = {"learn_rows_per_s": k * B / wall,
                      "learn_step_p95_ms": float(np.percentile(times, 95)) * 1e3,
                      "setup_s": setup_s}
    else:
        out["ctx"] = types.SimpleNamespace(
            kind="learn", cfg=loop.cfg, traffic=loop.traffic, trace=tr, n=k,
            items=items, pool=loop.pool, device=device)
    return out
