"""Multi-target QO -- the paper's §7 future-work extension (the
reference's ``core/multi.py``).

For multi-target regression (the iSOUP-Tree setting) each bin keeps one
(n, mean, M2) triple per target; the split merit is the mean variance
reduction across targets, each normalized by its target's whole-sample
variance (Kocev et al.).  A table is ``{"radius": () f32, "origin": ()
f32, "sum_x": (C,) f32, "y": Stats (C, T)}``.

Plain PyTorch on whatever device the table lives on (the reference has no
kernel for it): :func:`update` is one segment scatter a payload, two-pass
M2 and one Chan merge; :func:`best_split` takes the prefix Chan merge over
the C bins as a log-step scan (:func:`repro_torch.kernels.qo_query.
prefix_merge`: log2(C) merges, not C launches).  The reference's
``associative_scan`` combines the bins in another order, so the two agree
within f32 rounding, not bitwise.  Bin ids follow the reference's integer
semantics at extreme x (ROADMAP C1).  Tables are returned new.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as dv
from repro_torch.core import stats
from repro_torch.kernels.qo_query import (SplitResult, argmax_nan_first,
                                         boundaries, prefix_merge)
from repro_torch.kernels.qo_update_leaves import bin_ids_plain

MTQOTable = Dict[str, object]

__all__ = ["init", "update", "best_split", "n_slots"]


def init(capacity: int, n_targets: int, radius: float, origin: float = 0.0,
         *, device=None) -> MTQOTable:
    """Empty table of ``capacity`` bins for ``n_targets`` targets on
    ``device`` (default ``cuda``); radius and origin as in
    :func:`repro_torch.core.qo.init`."""
    dev = dv.resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"radius": torch.as_tensor(radius, **f32).reshape(()),
            "origin": torch.as_tensor(origin, **f32).reshape(()),
            "sum_x": torch.zeros((capacity,), **f32),
            "y": stats.init((capacity, n_targets), dev)}


def update(table: MTQOTable, x, Y, *, device=None) -> MTQOTable:
    """Fold a batch into the table -> a new table.  x: (n,) feature values;
    Y: (n, T) targets.  One quantized bin per row, all T targets."""
    dev = dv.resolve(device)
    dv.check_on(table["sum_x"], dev, "table")
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    Y = torch.as_tensor(Y, dtype=torch.float32, device=dev)
    cap, T = table["y"]["n"].shape
    ids = bin_ids_plain(table["radius"], table["origin"], x, cap).long()

    def segsum(v):
        return torch.zeros((cap,) + v.shape[1:], dtype=torch.float32,
                           device=dev).index_add_(0, ids, v)

    n_b = segsum(torch.ones_like(x))                               # (C,)
    sx_b = segsum(x)
    sy_b = segsum(Y)                                               # (C, T)
    safe = torch.where(n_b > 0, n_b, 1.0)[:, None]
    mean_b = torch.where(n_b[:, None] > 0, sy_b / safe, 0.0)
    m2_b = segsum((Y - mean_b[ids]) ** 2)
    tile = {"n": n_b[:, None].expand(cap, T), "mean": mean_b, "m2": m2_b}
    return {"radius": table["radius"], "origin": table["origin"],
            "sum_x": table["sum_x"] + sx_b,
            "y": stats.merge(table["y"], tile)}


def best_split(table: MTQOTable, *, device=None) -> SplitResult:
    """Mean-VR-across-targets split (multi-target Algorithm 2) as 0-d
    tensors: ``threshold``, ``merit`` (0 when not finite) and ``valid``
    (at least two occupied bins)."""
    dv.check_on(table["sum_x"], dv.resolve(device), "table")
    ybins = {k: v.T for k, v in table["y"].items()}               # (T, C)
    n0 = table["y"]["n"][:, 0]
    left = prefix_merge(ybins)
    tot = {k: v[:, -1:] for k, v in left.items()}                  # (T, 1)
    right = stats.subtract({k: v.expand_as(left[k]) for k, v in tot.items()},
                           left)
    n_tot = torch.clamp(tot["n"], min=1.0)
    vr_t = stats.variance(tot) \
        - (left["n"] / n_tot) * stats.variance(left) \
        - (right["n"] / n_tot) * stats.variance(right)             # (T, C)
    # normalize per target so large-scale targets don't dominate, then mean
    s2 = torch.clamp(stats.variance(tot), min=1e-12)
    vr = torch.mean(vr_t / s2, dim=0)                              # (C,)

    ok, cand = boundaries(n0, table["sum_x"])
    score = torch.where(ok, vr, float("-inf"))
    best = argmax_nan_first(score)
    return SplitResult(threshold=cand[best],
                       merit=torch.where(torch.isfinite(score[best]),
                                         score[best], 0.0),
                       valid=ok.any())


def n_slots(table: MTQOTable) -> torch.Tensor:
    """|H| -- the number of occupied bins, () i64."""
    return (table["y"]["n"][:, 0] > 0).sum()
