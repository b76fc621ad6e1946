"""Quantizer Observer (QO), one monitored feature -- the paper's core
object (§4; the reference's ``core/qo.py``).

A table is ``{"radius": () f32, "origin": () f32, "sum_x": (C,) f32,
"y": Stats (C,)}``: C fixed bins, bin id ``floor((x - origin)/radius)
+ C/2`` clipped into [0, C), per bin the robust target (n, mean, M2) and
the sum of x (the prototype numerator).

* :func:`update` is Algorithm 1 for a whole batch
  (:func:`repro_torch.kernels.ops.qo_update`: a CUDA kernel on the card);
* :func:`best_split` is Algorithm 2: the variance reduction at every
  boundary between occupied bins, from the prefix merge and the paper's
  subtraction (Eqs. 6-7), the threshold at the midpoint of neighbouring
  prototypes (:func:`repro_torch.kernels.ops.qo_best_split`).

Both run on the device the table lives on; :func:`init` puts it on
``cuda`` unless the caller names another device.  Tables are returned
new, never updated in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import device as dv
from repro_torch.core import stats
from repro_torch.kernels import ops as kops
from repro_torch.kernels.qo_query import SplitResult

QOTable = Dict[str, object]

__all__ = ["init", "update", "best_split", "merge_tables", "n_slots",
           "total_stats", "auto_radius", "SplitResult"]


def init(capacity: int, radius: float, origin: float = 0.0, *,
         device=None) -> QOTable:
    """Empty table of ``capacity`` bins on ``device`` (default ``cuda``).

    radius: quantization radius r (bin width); origin: the value mapped to
    the middle bin, so one table covers negative x too."""
    dev = dv.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"radius": torch.as_tensor(radius, **f32).reshape(()),
            "origin": torch.as_tensor(origin, **f32).reshape(()),
            "sum_x": torch.zeros((capacity,), **f32),
            "y": stats.init((capacity,), dev)}


def update(table: QOTable, x, y, w=None, *, device=None) -> QOTable:
    """Fold a batch (x, y and optional weights w, any shapes, flattened)
    into the table -> a new table.  Weight-0 rows vanish; integer weight k
    equals k unit inserts."""
    dev = dv.resolve(device)
    dv.check_on(table["sum_x"], dev, "table")
    return kops.qo_update(table, x, y, w)


def best_split(table: QOTable, *, device=None) -> SplitResult:
    """Paper Algorithm 2: 0-d ``threshold``, ``merit`` (VR; 0 when not
    valid) and ``valid`` (bool: at least two occupied bins)."""
    dv.check_on(table["sum_x"], dv.resolve(device), "table")
    return kops.qo_best_split(table)


def total_stats(table: QOTable) -> stats.Stats:
    """Whole-sample target statistics (merge of every bin)."""
    return stats.tree_reduce_merge(table["y"], 0)


def n_slots(table: QOTable) -> torch.Tensor:
    """|H| -- the number of occupied bins (the paper's memory metric)."""
    return (table["y"]["n"] > 0).sum()


def merge_tables(a: QOTable, b: QOTable) -> QOTable:
    """Merge two same-capacity tables (distributed estimation); radius and
    origin come from ``a`` (shards must quantize alike)."""
    return {"radius": a["radius"], "origin": a["origin"],
            "sum_x": a["sum_x"] + b["sum_x"],
            "y": stats.merge(a["y"], b["y"])}


def auto_radius(x_sample, k: float = 2.0) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The paper's dynamic radius policy: r = sigma / k and origin = the
    sample mean, from a warm-up sample (0-d tensors on its device).  The
    reference's ``capacity`` argument is unused there and dropped here."""
    x = torch.as_tensor(x_sample, dtype=torch.float32).reshape(-1)
    s = stats.from_batch(x)
    sigma = torch.sqrt(torch.clamp(stats.variance(s), min=1e-12))
    return sigma / k, s["mean"]
