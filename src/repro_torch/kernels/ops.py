"""Public forest-scale ops over the dict-of-tensors table layout.

Thin wrappers over the three kernel modules, mirroring the forest family
of the reference's ``src/repro/kernels/ops.py``.  Tables are (N, F, C)
with N any table-axis length (one tree's M, or a forest's folded T*M).
Each op launches its CUDA kernel on CUDA tensors and runs the kernel's
plain PyTorch version on CPU tensors; there is no other backend switch,
and no compile cache or batch bucketing (PyTorch runs eagerly).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import qo_query_batched, qo_route, qo_update_leaves

__all__ = ["forest_bin_ids", "forest_update", "forest_best_splits",
           "forest_route", "route", "sort_rows"]

sort_rows = qo_update_leaves.sort_rows


def forest_bin_ids(ao_radius, ao_origin, leaf, X, n_bins: int):
    """(B, F) int32 bin ids of each routed row in its leaf's tables, with
    the reference's integer semantics at extreme x (ROADMAP C1)."""
    leaf = leaf.long()
    return qo_update_leaves.bin_ids_plain(ao_radius[leaf], ao_origin[leaf],
                                          X, n_bins)


def forest_update(ao_y, ao_sum_x, ao_radius, ao_origin, leaf, X, y, w=None):
    """Absorb a routed batch into every (leaf, feature) QO table, IN PLACE.

    ao_y: Stats dict of (N, F, C); ao_sum_x: (N, F, C); ao_radius /
    ao_origin: (N, F); X: (B, F); y: (B,); leaf: (R,) table ids of R
    folded rows, R a multiple of B (row r reads ``X[r % B]``, ``y[r % B]``
    -- a forest passes its T*B folded rows without tiling X); w: optional
    (R,) sample weights.  Returns ``(ao_y, ao_sum_x)``, the same tensors.
    """
    leaf = leaf.reshape(-1)
    w = torch.ones(leaf.shape, dtype=torch.float32, device=X.device) \
        if w is None else w.reshape(-1)
    qo_update_leaves.absorb(ao_y, ao_sum_x, ao_radius, ao_origin, leaf,
                            X, y, w)
    return ao_y, ao_sum_x


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

