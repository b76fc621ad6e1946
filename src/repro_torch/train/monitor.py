"""QO telemetry -- the paper's observer as a runtime feature (the
reference's ``train/monitor.py``).

A monitor is a dict of QO tables, one per tracked signal (``loss``,
``grad_norm``, ``step_time``).  Each step folds its scalars into the
tables with the O(1) quantized update (paper Algorithm 1, through
:func:`repro_torch.core.qo.update`: the ``qo_update`` kernel on the card);
quantiles and variances are read off the bins
(:func:`repro_torch.core.sketch.quantile`).  The tables are a few KB
however long training runs.

* straggler detection: a step time above the p99 of the step-time table;
* loss-spike detection: a loss above mean + 6 sigma of the loss table.

Both need ``min_n`` observations first.  :func:`monitor_specs` places
every table replicated under a mesh: each rank holds the tables whole as
plain tensors and folds the same replicated scalars into them, so the
kernel never sees a DTensor.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as dv
from repro_torch.core import qo as qo_lib
from repro_torch.core import sketch, stats

__all__ = ["BINS", "SIGNALS", "init_monitor", "monitor_specs", "observe",
           "is_straggler", "loss_spike", "summaries"]

BINS = 128
SIGNALS = ("loss", "grad_norm", "step_time")


def init_monitor(*, device=None) -> Dict[str, qo_lib.QOTable]:
    """Empty monitor on ``device`` (default ``cuda``): cold-start fixed
    radii (paper §5.2); loss and grad norms live on ~1e-2..1e2."""
    dev = dv.resolve(device)
    return {"loss": qo_lib.init(BINS, radius=0.1, origin=5.0, device=dev),
            "grad_norm": qo_lib.init(BINS, radius=0.05, origin=1.0,
                                     device=dev),
            "step_time": qo_lib.init(BINS, radius=0.05, origin=1.0,
                                     device=dev)}


def monitor_specs():
    """Monitor tables are tiny: replicate (a
    :class:`repro_torch.train.sharding.Spec` of no axes a leaf)."""
    from repro_torch.train.sharding import Spec

    def rep(tree):
        if isinstance(tree, dict):
            return {k: rep(v) for k, v in tree.items()}
        return Spec()
    return rep(init_monitor(device="meta"))


def observe(mon, *, loss=None, grad_norm=None, step_time=None):
    """Fold one step's scalars (any given subset) -> a new monitor."""
    new = dict(mon)
    for name, val in (("loss", loss), ("grad_norm", grad_norm),
                      ("step_time", step_time)):
        if val is not None:
            dev = mon[name]["sum_x"].device
            v = torch.as_tensor(val, dtype=torch.float32,
                                device=dev).reshape(1)
            new[name] = qo_lib.update(mon[name], v, v, device=dev)
    return new


def is_straggler(mon, step_time, q=0.99, min_n=32):
    """0-d bool: ``step_time`` above the q-quantile of the step times."""
    t = mon["step_time"]
    tot = qo_lib.total_stats(t)
    thr = sketch.quantile(t, q)
    return (tot["n"] >= min_n) & (torch.as_tensor(
        step_time, dtype=torch.float32, device=thr.device) > thr)


def loss_spike(mon, loss, n_sigma=6.0, min_n=32):
    """0-d bool: ``loss`` above mean + n_sigma * std of the losses."""
    tot = qo_lib.total_stats(mon["loss"])
    sd = stats.stddev(tot)
    return (tot["n"] >= min_n) & (torch.as_tensor(
        loss, dtype=torch.float32, device=sd.device)
        > tot["mean"] + n_sigma * sd)


def summaries(mon):
    """Per signal: count, mean, std, occupied slots, p50, p90, p99."""
    return {k: sketch.summary(v) for k, v in mon.items()}
