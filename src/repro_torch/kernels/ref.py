"""Oracles of the seed engine (``split_backend="oracle"``): the
reference's ``kernels/ref.py`` functions that the oracle engine calls.

Plain PyTorch that launches no kernel of the port, on any device: the
scalar routing walk and the per-table split query, kept as the
correctness reference of the kernel engine.  The rest of the reference's
``ref.py`` (``pack_table``, ``unpack_table``, ``qo_update_ref``,
``qo_query_ref``, ``forest_update_ref``, ``forest_merge_ref``,
``sketch_*_ref``) serves the Pallas kernels' dense (8, C) table layout,
which the port does not have: each kernel's plain version plays that
role here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import qo_query

__all__ = ["route_ref", "forest_route_ref", "forest_query_ref"]


def route_ref(feature, threshold, child, is_leaf, X, max_depth: int):
    """The seed's scalar walk of every row: ``max_depth + 1`` plies of
    ``node = x[f] <= thr ? left : right`` (NaN goes right), a leaf keeps
    its node.  feature/threshold/is_leaf: (M,); child: (M, 2); X: (B, F).
    Returns (B,) int32 leaf ids."""
    B = X.shape[0]
    rows = torch.arange(B, device=X.device)
    node = torch.zeros(B, dtype=torch.long, device=X.device)
    for _ in range(max_depth + 1):
        go_left = X[rows, feature[node].long()] <= threshold[node]
        nxt = torch.where(go_left, child[node, 0], child[node, 1]).long()
        node = torch.where(is_leaf[node], node, nxt)
    return node.to(torch.int32)


def forest_route_ref(feature, threshold, child, is_leaf, X, max_depth: int):
    """:func:`route_ref` of each of T trees in turn: arrays with a leading
    (T,) axis -> (T, B) int32 per-tree leaf ids."""
    return torch.stack([route_ref(feature[t], threshold[t], child[t],
                                  is_leaf[t], X, max_depth)
                        for t in range(feature.shape[0])])


def forest_query_ref(ao_y, ao_sum_x, attempt):
    """The plain single-table best split of every (leaf, feature) table
    (:func:`repro_torch.kernels.qo_query.scores_plain` over a leading
    (N, F) axis), as the reference's ``vmap(vmap(qo.best_split))``.
    ao_y: Stats of (N, F, C); ao_sum_x: (N, F, C); attempt: (N,) bool.
    Returns (merit, thr), both (N, F): merit -inf where the table's leaf
    does not attempt or no boundary exists, 0 where the best is not
    finite."""
    score, cand = qo_query.scores_plain(ao_y["n"], ao_y["mean"], ao_y["m2"],
                                        ao_sum_x)
    b = qo_query.argmax_nan_first(score)[..., None]
    best = torch.gather(score, -1, b)[..., 0]
    thr = torch.gather(cand, -1, b)[..., 0]
    valid = (~torch.isneginf(score)).any(-1)
    merit = torch.where(torch.isfinite(best), best, 0.0)
    return torch.where(valid & attempt[:, None], merit, float("-inf")), thr
