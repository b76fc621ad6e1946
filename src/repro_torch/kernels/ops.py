"""Public ops over the dict-of-tensors table layout.

Thin wrappers over the kernel modules, mirroring the single-table, forest
and sketch families of the reference's ``src/repro/kernels/ops.py``.
Forest tables are (N, F, C) with N any table-axis length (one tree's M,
or a forest's folded T*M); a sketch's last axis holds K centroids.
Each op launches its CUDA kernel on CUDA tensors and runs the kernel's
plain PyTorch version on CPU tensors; there is no other backend switch,
and no compile cache or batch bucketing (PyTorch runs eagerly).
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch as sketch_lib
from repro_torch.kernels import (qo_merge, qo_query, qo_query_batched,
                                 qo_route, qo_update_leaves)
from repro_torch.kernels.qo_update import update as _qo_update_planes

__all__ = ["qo_update", "qo_best_split", "forest_bin_ids", "forest_update",
           "forest_merge", "forest_best_splits", "forest_route", "route",
           "sort_rows", "sketch_update", "sketch_merge", "sketch_to_bins"]

sort_rows = qo_update_leaves.sort_rows


# --------------------------------------------------------------------------
# single-table ops
# --------------------------------------------------------------------------

def qo_update(table, x, y, w=None):
    """Kernel-backed :func:`repro_torch.core.qo.update` on the table's
    device: x, y and optional w (any shapes, flattened) -> a new table."""
    dev = table["sum_x"].device
    as32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                     device=dev).reshape(-1).contiguous()
    x, y = as32(x), as32(y)
    w = torch.ones_like(x) if w is None else as32(w)
    ty = table["y"]
    n, mean, m2, sum_x = _qo_update_planes(
        ty["n"], ty["mean"], ty["m2"], table["sum_x"], table["radius"],
        table["origin"], x, y, w)
    return {"radius": table["radius"], "origin": table["origin"],
            "sum_x": sum_x, "y": {"n": n, "mean": mean, "m2": m2}}


def qo_best_split(table) -> qo_query.SplitResult:
    """Kernel-backed :func:`repro_torch.core.qo.best_split`: every
    boundary evaluated and the best one picked in one launch."""
    ty = table["y"]
    return qo_query.split(*(a.contiguous() for a in (
        ty["n"], ty["mean"], ty["m2"], table["sum_x"])))


# --------------------------------------------------------------------------
# forest ops
# --------------------------------------------------------------------------

def forest_bin_ids(ao_radius, ao_origin, leaf, X, n_bins: int):
    """(B, F) int32 bin ids of each routed row in its leaf's tables, with
    the reference's integer semantics at extreme x (ROADMAP C1)."""
    leaf = leaf.long()
    return qo_update_leaves.bin_ids_plain(ao_radius[leaf], ao_origin[leaf],
                                          X, n_bins)


def forest_update(ao_y, ao_sum_x, ao_radius, ao_origin, leaf, X, y, w=None,
                  rows=None):
    """Absorb a routed batch into every (leaf, feature) QO table, IN PLACE.

    ao_y: Stats dict of (N, F, C); ao_sum_x: (N, F, C); ao_radius /
    ao_origin: (N, F); X: (B, F); y: (B,); leaf: (R,) table ids of R
    folded rows, R a multiple of B (row r reads ``X[r % B]``, ``y[r % B]``
    -- a forest passes its T*B folded rows without tiling X); w: optional
    (R,) sample weights; rows: optional ``(order, offsets)`` of
    :func:`sort_rows` for ``leaf`` when the caller sorted already (the
    kernel walks them; the plain version ignores them).  Returns
    ``(ao_y, ao_sum_x)``, the same tensors.
    """
    leaf = leaf.reshape(-1)
    w = torch.ones(leaf.shape, dtype=torch.float32, device=X.device) \
        if w is None else w.reshape(-1)
    qo_update_leaves.absorb(ao_y, ao_sum_x, ao_radius, ao_origin, leaf,
                            X, y, w, rows)
    return ao_y, ao_sum_x


def forest_merge(a_y, a_sum_x, b_y, b_sum_x):
    """Chan-merge two same-shape (N, F, C) QO table sets (DESIGN.md §4.1):
    per-bin (n, mean, M2) through the Chan operator (Eqs. 4-5,
    empty-operand safe) and ``sum_x`` summed.  N is any table-axis length
    (a forest's folded T*M, or h shard deltas folded in).  Returns new
    ``(ao_y, ao_sum_x)``; radius/origin do not ride through (the shards
    share the forest's grid).  The data-parallel sync reduces shard deltas
    with it and folds the result into the forest."""
    n, mean, m2, sum_x = qo_merge.merge(*(a.contiguous() for a in (
        a_y["n"], a_y["mean"], a_y["m2"], a_sum_x,
        b_y["n"], b_y["mean"], b_y["m2"], b_sum_x)))
    return {"n": n, "mean": mean, "m2": m2}, sum_x


def forest_best_splits(ao_y, ao_sum_x, attempt):
    """Best split candidate of every attempting (leaf, feature) table.

    attempt: (N,) bool.  The K attempting rows are compacted with
    ``torch.nonzero`` (one host read of K) and only they are queried; K = 0
    queries nothing.  Returns (merit, thr), both (N, F): -inf / 0 on rows
    that do not attempt or have no valid boundary.
    """
    N, F, _ = ao_sum_x.shape
    dev = ao_sum_x.device
    merit = torch.full((N, F), float("-inf"), dtype=torch.float32,
                       device=dev)
    thr = torch.zeros((N, F), dtype=torch.float32, device=dev)
    rows = torch.nonzero(attempt.reshape(-1)).reshape(-1)
    if rows.numel() == 0:
        return merit, thr
    mk, tk = qo_query_batched.best_splits(ao_y, ao_sum_x,
                                          rows.to(torch.int32))
    merit[rows] = mk
    thr[rows] = tk
    return merit, thr


def forest_route(feature, threshold, child, is_leaf, X, *, depth: int):
    """Route X (B, F) through T trees at once -> (T, B) int32 leaf ids.

    feature/threshold/is_leaf: (T, M); child: (T, M, 2), -1 at leaves.
    ``depth``: any bound >= the deepest realized leaf gives the same ids
    (leaves self-loop)."""
    T, M = feature.shape
    feat, thr, left, right = qo_route.fold_route_tables(
        feature, threshold, child, is_leaf)
    return qo_route.forest_route_folded(feat, thr, left, right,
                                        X.contiguous(), T, M, int(depth))


def route(feature, threshold, child, is_leaf, X, *, depth: int):
    """Single-tree view of :func:`forest_route` -> (B,) int32 leaf ids."""
    return forest_route(feature[None], threshold[None], child[None],
                        is_leaf[None], X, depth=depth)[0]



# --------------------------------------------------------------------------
# sketch-observer ops: K rank-bucket centroids per (leaf, feature)
# --------------------------------------------------------------------------

def sketch_merge(a_y, a_sum_x, b_y, b_sum_x):
    """Merge two same-shape (N, F, K) sketch table sets: the 2K centroids
    of each table compacted back to K.  Returns new ``(ao_y, ao_sum_x)``.
    The elementwise Chan merge would be wrong here: slot i of two
    sketches covers different rank ranges."""
    n, mean, m2, sum_x = sketch_lib.merge_planes(
        a_y["n"], a_y["mean"], a_y["m2"], a_sum_x,
        b_y["n"], b_y["mean"], b_y["m2"], b_sum_x)
    return {"n": n, "mean": mean, "m2": m2}, sum_x


def sketch_update(ao_y, ao_sum_x, leaf, X, y, w=None):
    """Absorb a routed batch into every (N, F, K) sketch, out of place.

    leaf: (R,) table ids (-1 rows vanish), R a multiple of B; X: (B, F);
    y: (B,); w: optional (R,) weights.  Row r reads ``X[r % B]`` (a
    forest passes its T*B folded rows without tiling X).  One batch is ONE
    compaction of every table: pre-sketch, then :func:`sketch_merge`.
    Returns new ``(ao_y, ao_sum_x)``."""
    N, _, K = ao_sum_x.shape
    leaf = leaf.reshape(-1)
    w = torch.ones(leaf.shape, dtype=torch.float32, device=X.device) \
        if w is None else w.reshape(-1)
    b_n, b_mean, b_m2, b_sx = sketch_lib.from_batch_planes(leaf, X, y, w,
                                                           N, K)
    return sketch_merge(ao_y, ao_sum_x,
                        {"n": b_n, "mean": b_mean, "m2": b_m2}, b_sx)


def sketch_to_bins(ao_y, ao_sum_x):
    """Sketch state -> query-ready bins: centroids in ascending-prototype
    order ARE a sorted bin table, so this is a stable sort along the slot
    axis (the identity on the state :func:`sketch_update` keeps) and
    :func:`forest_best_splits` consumes the result unchanged."""
    n, mean, m2, sum_x = (a.contiguous() for a in sketch_lib.sort_planes(
        ao_y["n"], ao_y["mean"], ao_y["m2"], ao_sum_x))
    return {"n": n, "mean": mean, "m2": m2}, sum_x
