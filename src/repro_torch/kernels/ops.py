"""Public ops over the dict-of-tensors table layout.

Thin wrappers over the kernel modules, mirroring the single-table, forest
and sketch families of the reference's ``src/repro/kernels/ops.py``.
Forest tables are (N, F, C) with N any table-axis length (one tree's M,
or a forest's folded T*M); a sketch's last axis holds K centroids.
Each op launches its CUDA kernel on CUDA tensors and runs the kernel's
plain PyTorch version on CPU tensors; there is no other backend switch,
and no compile cache or batch bucketing (PyTorch runs eagerly).

Tuned launch shapes.  A kernel's rows, warps or threads a block are
*schedule* knobs: every compiled value gives the same bits.
:data:`DEFAULT_PARAMS` holds today's values per dispatch family (the
reference's family names), :mod:`repro_torch.perf.tune` measures better
ones and installs them per (family, backend, shape class) through
:func:`set_tuning`, and each op resolves its knobs with :func:`tuned`:
the defaults, then the installed entry, then an explicit keyword that is
not None.  The backend is ``"cuda"`` on a CUDA tensor and ``"plain"`` on
a CPU one; the plain versions never see a knob, but a value the kernel was
not compiled for raises ValueError on either.  ``qo_update`` and
``forest_update`` have only stream knobs (how a batch flows through a
sequential Chan merge): their :data:`DEFAULT_PARAMS` record the compiled
values, which nothing can change
(``repro_torch.perf.tune.KERNEL_STREAM_KNOBS``).
"""
from __future__ import annotations

import torch

from repro_torch.core import sketch as sketch_lib
from repro_torch.kernels import (qo_merge, qo_query, qo_query_batched,
                                 qo_route, qo_update_leaves, sketch_compact)
from repro_torch.kernels import qo_update as qo_update_planes
from repro_torch.perf.spans import count

__all__ = ["qo_update", "qo_best_split", "forest_bin_ids", "forest_update",
           "forest_merge", "forest_best_splits", "forest_route", "route",
           "sort_rows", "sketch_update", "sketch_merge", "sketch_to_bins",
           "DEFAULT_PARAMS", "set_tuning", "get_tuning", "tuned",
           "backend_of"]

sort_rows = qo_update_leaves.sort_rows


# --------------------------------------------------------------------------
# tuned launch parameters (populated by repro_torch.perf.tune)
# --------------------------------------------------------------------------

#: Today's launch shapes per dispatch family: what an untuned process
#: launches, and a point of every family's grid in
#: ``repro_torch.perf.tune.SEARCH_SPACE``.  The two update families hold
#: their stream knobs' compiled values (``qo_update``'s ``step`` and
#: ``tile_bins`` are ``STEP`` and ``TILE_BINS`` in ``csrc/qo_update.cu``).
DEFAULT_PARAMS = {
    "qo_update": {"pieces": qo_update_planes.PIECES, "step": 128,
                  "tile_bins": 1024},
    "forest_update": {"piece_rows": qo_update_leaves.PIECE_ROWS},
    "forest_query": {"warps": qo_query_batched.WARPS},
    "forest_route": {"rows": qo_route.ROWS},
    "forest_merge": {"threads": qo_merge.THREADS},
    "sketch_update": {"warps": sketch_compact.WARPS,
                      "gen_warps": sketch_compact.GEN_WARPS},
    "sketch_merge": {"warps": sketch_compact.WARPS,
                     "gen_warps": sketch_compact.GEN_WARPS},
}

# (family, backend, shape_class) -> {param: value}; the perf layer swaps
# the whole dict in (kernels never import the tuner)
_TUNING: dict = {}


def set_tuning(table: dict) -> None:
    """Install tuned launch parameters, ``{(family, backend,
    shape_class): {param: value}}``, replacing the whole table.  Entries
    apply only where the caller left a parameter unspecified; unknown
    params are ignored by :func:`tuned`."""
    global _TUNING
    _TUNING = dict(table)


def get_tuning() -> dict:
    """The installed tuning table (a copy)."""
    return dict(_TUNING)


def tuned(family: str, backend: str, shape_class: str, **overrides):
    """The launch parameters of one (family, backend, shape class):
    :data:`DEFAULT_PARAMS`, then the installed entry, then each override
    that is not None.  A fresh dict; a pure lookup."""
    p = dict(DEFAULT_PARAMS[family])
    entry = _TUNING.get((family, backend, shape_class))
    if entry:
        p.update({k: v for k, v in entry.items() if k in p})
    p.update({k: v for k, v in overrides.items() if v is not None})
    return p


def backend_of(t) -> str:
    """``"cuda"`` for a tensor on the card (the kernels), else
    ``"plain"``."""
    return "cuda" if t.is_cuda else "plain"


def _shape_class_tables(M: int, F: int, C: int) -> str:
    """Tuner key of the table-axis families: the (M, F, C) geometry, M any
    table-axis length (a forest's folded T*M)."""
    return f"M{M}xF{F}xC{C}"


def _shape_class_route(T: int, M: int, F: int) -> str:
    """Tuner key of the routing family: trees, nodes a tree, features."""
    return f"T{T}xM{M}xF{F}"


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
    n, mean, m2, sum_x = qo_update_planes.update(
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


def forest_merge(a_y, a_sum_x, b_y, b_sum_x, *, threads=None):
    """Chan-merge two same-shape (N, F, C) QO table sets (DESIGN.md §4.1):
    per-bin (n, mean, M2) through the Chan operator (Eqs. 4-5,
    empty-operand safe) and ``sum_x`` summed.  N is any table-axis length
    (a forest's folded T*M, or h shard deltas folded in).  Returns new
    ``(ao_y, ao_sum_x)``; radius/origin do not ride through (the shards
    share the forest's grid).  The data-parallel sync reduces shard deltas
    with it and folds the result into the forest.  ``threads``: threads a
    block (else the tuned entry's or the default)."""
    p = tuned("forest_merge", backend_of(a_sum_x),
              _shape_class_tables(*a_sum_x.shape), threads=threads)
    n, mean, m2, sum_x = qo_merge.merge(*(a.contiguous() for a in (
        a_y["n"], a_y["mean"], a_y["m2"], a_sum_x,
        b_y["n"], b_y["mean"], b_y["m2"], b_sum_x)), **p)
    return {"n": n, "mean": mean, "m2": m2}, sum_x


def forest_best_splits(ao_y, ao_sum_x, attempt, compact: bool = True, *,
                       warps=None):
    """Best split candidate of every attempting (leaf, feature) table.

    attempt: (N,) bool.  The K attempting rows are compacted with
    ``torch.nonzero`` (one host read of K) and only they are queried; K = 0
    queries nothing.  ``compact=False`` queries all N rows in one launch
    and masks the rows that do not attempt (the full-scan reference; the
    same values, since every table is queried on its own).  Returns
    (merit, thr), both (N, F): -inf / 0 on rows that do not attempt or
    have no valid boundary.  ``warps``: the most warps a block (else the
    tuned entry's or the default).
    """
    N, F, C = ao_sum_x.shape
    dev = ao_sum_x.device
    p = tuned("forest_query", backend_of(ao_sum_x),
              _shape_class_tables(N, F, C), warps=warps)
    attempt = attempt.reshape(-1)
    if not compact:
        mk, tk = qo_query_batched.best_splits(
            ao_y, ao_sum_x, torch.arange(N, dtype=torch.int32, device=dev),
            **p)
        keep = attempt[:, None]
        return (torch.where(keep, mk, float("-inf")),
                torch.where(keep, tk, 0.0))
    merit = torch.full((N, F), float("-inf"), dtype=torch.float32,
                       device=dev)
    thr = torch.zeros((N, F), dtype=torch.float32, device=dev)
    rows = torch.nonzero(attempt).reshape(-1)
    count("forest.attempted_leaves", rows.numel())
    if rows.numel() == 0:
        return merit, thr
    mk, tk = qo_query_batched.best_splits(ao_y, ao_sum_x,
                                          rows.to(torch.int32), **p)
    merit[rows] = mk
    thr[rows] = tk
    return merit, thr


def forest_route(feature, threshold, child, is_leaf, X, *, depth: int,
                 rows=None):
    """Route X (B, F) through T trees at once -> (T, B) int32 leaf ids.

    feature/threshold/is_leaf: (T, M); child: (T, M, 2), -1 at leaves.
    ``depth``: any bound >= the deepest realized leaf gives the same ids
    (leaves self-loop).  ``rows``: rows a block (else the tuned entry's or
    the default)."""
    T, M = feature.shape
    p = tuned("forest_route", backend_of(X),
              _shape_class_route(T, M, X.shape[1]), rows=rows)
    return qo_route.forest_route(feature, threshold, child, is_leaf,
                                 X.contiguous(), int(depth), **p)


def route(feature, threshold, child, is_leaf, X, *, depth: int, rows=None):
    """Single-tree view of :func:`forest_route` -> (B,) int32 leaf ids."""
    return forest_route(feature[None], threshold[None], child[None],
                        is_leaf[None], X, depth=depth, rows=rows)[0]



# --------------------------------------------------------------------------
# sketch-observer ops: K rank-bucket centroids per (leaf, feature)
# --------------------------------------------------------------------------

def _sketch_compact(family, a_y, a_sum_x, b_y, b_sum_x, warps, gen_warps):
    p = tuned(family, backend_of(a_sum_x),
              _shape_class_tables(*a_sum_x.shape), warps=warps,
              gen_warps=gen_warps)
    n, mean, m2, sum_x = sketch_lib.merge_planes(
        a_y["n"], a_y["mean"], a_y["m2"], a_sum_x,
        b_y["n"], b_y["mean"], b_y["m2"], b_sum_x, **p)
    return {"n": n, "mean": mean, "m2": m2}, sum_x


def sketch_merge(a_y, a_sum_x, b_y, b_sum_x, *, warps=None, gen_warps=None):
    """Merge two same-shape (N, F, K) sketch table sets: the 2K centroids
    of each table compacted back to K.  Returns new ``(ao_y, ao_sum_x)``.
    The elementwise Chan merge would be wrong here: slot i of two
    sketches covers different rank ranges.  ``warps``, ``gen_warps``: the
    compaction's warps a block (else the tuned entry's or the
    defaults)."""
    return _sketch_compact("sketch_merge", a_y, a_sum_x, b_y, b_sum_x, warps,
                           gen_warps)


def sketch_update(ao_y, ao_sum_x, leaf, X, y, w=None, *, warps=None,
                  gen_warps=None):
    """Absorb a routed batch into every (N, F, K) sketch, out of place.

    leaf: (R,) table ids (-1 rows vanish), R a multiple of B; X: (B, F);
    y: (B,); w: optional (R,) weights.  Row r reads ``X[r % B]`` (a
    forest passes its T*B folded rows without tiling X).  One batch is ONE
    compaction of every table: pre-sketch, then the merge of
    :func:`sketch_merge` (its knobs resolved under ``sketch_update``).
    Returns new ``(ao_y, ao_sum_x)``."""
    N, _, K = ao_sum_x.shape
    leaf = leaf.reshape(-1)
    w = torch.ones(leaf.shape, dtype=torch.float32, device=X.device) \
        if w is None else w.reshape(-1)
    b_n, b_mean, b_m2, b_sx = sketch_lib.from_batch_planes(leaf, X, y, w,
                                                           N, K)
    return _sketch_compact("sketch_update", ao_y, ao_sum_x,
                           {"n": b_n, "mean": b_mean, "m2": b_m2}, b_sx,
                           warps, gen_warps)


def sketch_to_bins(ao_y, ao_sum_x):
    """Sketch state -> query-ready bins: centroids in ascending-prototype
    order ARE a sorted bin table, so this is a stable sort along the slot
    axis (the identity on the state :func:`sketch_update` keeps) and
    :func:`forest_best_splits` consumes the result unchanged."""
    n, mean, m2, sum_x = (a.contiguous() for a in sketch_lib.sort_planes(
        ao_y["n"], ao_y["mean"], ao_y["m2"], ao_sum_x))
    return {"n": n, "mean": mean, "m2": m2}, sum_x
