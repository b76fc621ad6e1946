"""Mergeable quantile sketches over the paper's (n, mean, M2) algebra (the
reference's ``core/sketch.py``, DESIGN.md §2.8).

Two roles, both built on the Chan merge (Eqs. 4-5) being associative and
commutative:

* **QO-table telemetry:** :func:`quantile` and :func:`summary` read
  approximate x-quantiles off a QO table's dense bin occupancy.  The
  reference's ``all_merge`` (a ``lax`` collective across mesh axes) goes
  with the data-parallel port (ROADMAP A10) and is not here.
* **The sketch attribute observer** (``HTRConfig(observer_backend=
  "sketch")``): each (leaf, feature) slot holds K weighted centroids --
  the same four planes as a QO bin (target n, mean, M2 and ``sum_x``) --
  in ascending-prototype order, so the QO split query consumes them
  unchanged (an empty slot is an identity of the prefix merge).

Sketch algebra, deterministic and with static shapes:

* a **compaction** of J centroids to K buckets sorts by prototype
  (stable; empties carry +inf and sink to the tail), puts each centroid in
  the bucket of its cumulative-weight midpoint
  ``floor((cumw_i - n_i/2) * K / tot)`` and reduces each bucket exactly
  (:mod:`repro_torch.kernels.sketch_compact`, a CUDA kernel on the card);
* **merge(A, B)** concatenates the 2K centroids and compacts back to K;
* **update** pre-sketches the batch per leaf (rows sorted by (leaf, x),
  within-leaf rank buckets) and merges.

A compaction is not the identity on a compact sketch: K centroids with
weights [1, 1, 1, 97] re-bucket as [0, 0, 0, 2], so every table is
re-compacted on every batch, as in the reference, also a leaf's that saw
no row.

Sort keys are canonicalized (``x + 0.0``): a radix sort on the card may
order -0.0 before +0.0, which the reference's sort treats as equal.
Integer casts follow XLA (ROADMAP C1): +inf saturates to INT32_MAX before
the clip, NaN casts to 0.  Sums over sorted runs use
``torch.segment_reduce``, never float atomics, so a rerun on the card is
bitwise equal.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as dv
from repro_torch.core import stats
from repro_torch.kernels import qo_query, sketch_compact
from repro_torch.kernels.qo_update_leaves import xla_int32

__all__ = [
    "quantile", "summary",
    "SKTable", "init", "update", "merge", "best_split", "from_batch",
    "quantile_sk", "total_stats", "n_slots",
    "prototypes", "sort_planes", "compact_planes", "from_batch_planes",
    "merge_planes",
]

SKTable = Dict[str, object]


# --------------------------------------------------------------------------
# QO-table telemetry
# --------------------------------------------------------------------------

def _filled_quantiles(n, proto, q):
    """Prototype at the first cumulative-weight crossing of each q."""
    q = torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32,
                                         device=n.device))
    cum = torch.cumsum(n, 0)
    total = torch.clamp(cum[-1], min=1e-30)
    pos = torch.searchsorted(cum, q * total)
    out = proto[torch.clamp(pos, 0, n.shape[0] - 1)]
    return out[0] if out.shape == (1,) else out


def quantile(table, q):
    """Approximate q-quantile(s) of the x values a QO table monitored: the
    prototype of the bin where the occupancy CDF crosses q, empty bins
    filled with the previous occupied prototype."""
    n = table["y"]["n"]
    occ = n > 0
    proto = torch.where(occ, table["sum_x"] / torch.where(occ, n, 1.0), 0.0)
    idx = torch.arange(n.shape[0], device=n.device)
    last = torch.cummax(torch.where(occ, idx, -1), 0).values
    cum = torch.cumsum(n, 0)
    q = torch.atleast_1d(torch.as_tensor(q, dtype=torch.float32,
                                         device=n.device))
    pos = torch.searchsorted(cum, q * torch.clamp(cum[-1], min=1.0))
    out = proto[torch.clamp(last, min=0)][torch.clamp(pos, 0,
                                                      n.shape[0] - 1)]
    return out[0] if out.shape == (1,) else out


def summary(table) -> Dict[str, torch.Tensor]:
    """Scalar digest of a QO table: count / mean / std / occupancy / p50 /
    p90 / p99."""
    tot = stats.tree_reduce_merge(table["y"], 0)
    qs = quantile(table, [0.5, 0.9, 0.99])
    return {"count": tot["n"], "mean": tot["mean"],
            "std": stats.stddev(tot), "slots": (table["y"]["n"] > 0).sum(),
            "p50": qs[0], "p90": qs[1], "p99": qs[2]}


# --------------------------------------------------------------------------
# sketch-observer plane algebra: (..., J) planes n / mean / m2 / sum_x
# --------------------------------------------------------------------------

def prototypes(n, sum_x, empty: float = float("inf")):
    """Per-centroid prototype ``sum_x / n``, ``empty`` at n == 0 slots."""
    return torch.where(n > 0, sum_x / torch.where(n > 0, n, 1.0), empty)


def sort_planes(n, mean, m2, sum_x):
    """Stable sort of the centroids along the last axis by ascending
    prototype, empties last (the identity on well-formed sketch state)."""
    key = prototypes(n, sum_x) + 0.0
    order = torch.sort(key, dim=-1, stable=True).indices
    return tuple(torch.gather(a, -1, order) for a in (n, mean, m2, sum_x))


def _bucket_ids(n_sorted, k_out: int):
    """int32 rank bucket of each sorted centroid: its cumulative-weight
    midpoint scaled to ``k_out`` buckets, clipped."""
    cumw = torch.cumsum(n_sorted, -1)
    tot = torch.clamp(cumw[..., -1:], min=1e-30)
    mid = cumw - 0.5 * n_sorted
    return torch.clamp(xla_int32(mid * (k_out / tot)), 0,
                       k_out - 1).to(torch.int32)


def compact_planes(n, mean, m2, sum_x, k_out: int):
    """Compact (..., J) centroid planes to (..., k_out): sort, rank-bucket,
    reduce each bucket exactly.  The output is ascending-prototype."""
    n, mean, m2, sum_x = (a.contiguous() for a in
                          sort_planes(n, mean, m2, sum_x))
    return sketch_compact.bucket_reduce(n, mean, m2, sum_x,
                                        _bucket_ids(n, k_out), k_out)


def merge_planes(a_n, a_mean, a_m2, a_sum_x, b_n, b_mean, b_m2, b_sum_x):
    """Merge two same-shape (..., K) sketches: the 2K centroids compacted
    back to K.  The empty sketch (all zeros) is an identity."""
    k = a_n.shape[-1]
    cat = lambda a, b: torch.cat([a, b], -1)
    return compact_planes(cat(a_n, b_n), cat(a_mean, b_mean),
                          cat(a_m2, b_m2), cat(a_sum_x, b_sum_x), k)


def from_batch_planes(leaf, X, y, w, n_tables: int, k: int):
    """Pre-sketch one routed batch into per-(table, feature) rank buckets.

    leaf: (R,) table ids (-1: a dropped row); X: (B, F); y: (B,); w: (R,);
    R a multiple of B, row r reads ``X[r % B]`` and ``y[r % B]`` (a forest
    passes its T*B folded rows without tiling X).  Returns four
    (n_tables, F, k) planes.  Per feature the rows sort by (leaf, x), each
    row's within-leaf cumulative-weight midpoint picks its bucket, and the
    buckets reduce with the exact two-pass form.  Weight-0 rows vanish.
    """
    R = leaf.shape[0]
    B, F = X.shape
    dev = X.device
    if R != B:
        b = torch.arange(R, device=dev) % B
        X, y = X[b], y[b]
    leaf = leaf.to(torch.int64)
    valid = leaf >= 0
    # dropped rows are weightless BEFORE the cumulative sums: they sort to
    # the front of every run and would inflate each real row's rank
    w = torch.where(valid, w, 0.0)
    xT = X.T.contiguous()                                  # (F, R)
    # two-key stable sort, (leaf, x): by x, then stably by leaf
    o1 = torch.sort(xT + 0.0, dim=-1, stable=True).indices
    o2 = torch.sort(leaf[o1], dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    leaf_s = leaf[order]
    x_s = torch.gather(xT, -1, order)
    y_s, w_s = y[order], w[order]
    valid_s = leaf_s >= 0
    # dropped rows (sorted first) join table 0's runs with zero payload
    safe = torch.clamp(leaf_s, min=0)

    counts = torch.bincount(safe[0], minlength=n_tables)
    if counts.numel() != n_tables:
        raise ValueError(f"leaf ids reach {counts.numel() - 1}, the table "
                         f"axis holds {n_tables}")
    # within-leaf inclusive cumulative weight: the running sum minus the
    # mass of every smaller leaf id (rows are leaf-major after the sort)
    tot_l = torch.segment_reduce(w_s[0], "sum", lengths=counts)
    offset = torch.cumsum(tot_l, 0) - tot_l
    cumw = torch.cumsum(w_s, -1) - offset[safe]
    tot = torch.clamp(tot_l[safe], min=1e-30)
    mid = cumw - 0.5 * w_s
    bucket = torch.clamp(xla_int32(mid * (k / tot)), 0, k - 1)
    bucket = torch.where(valid_s, bucket, 0)

    # one flat segmented sum over (feature, table, bucket): that key is
    # non-decreasing along the flattened (F, R) rows, so every segment is
    # one contiguous run; only the runs present are reduced (most of the
    # F * n_tables * k segments are empty in a batch) and placed after
    f_row = torch.arange(F, device=dev)[:, None]
    seg = ((f_row * n_tables + safe) * k + bucket).reshape(-1)
    ids, lengths = torch.unique_consecutive(seg, return_counts=True)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def runsum(v):
        return torch.segment_reduce(torch.where(valid_s, v, zero).reshape(-1),
                                    "sum", lengths=lengths)

    n_r, sy_r, sx_r = runsum(w_s), runsum(w_s * y_s), runsum(w_s * x_s)
    mean_r = torch.where(n_r > 0, sy_r / torch.where(n_r > 0, n_r, 1.0), 0.0)
    mean_rows = torch.repeat_interleave(mean_r, lengths, output_size=F * R)
    m2_r = runsum(w_s * (y_s - mean_rows.reshape(F, R)) ** 2)
    m2_r = torch.where(n_r > 0, m2_r, 0.0)

    def place(v):
        out = torch.zeros(F * n_tables * k, dtype=torch.float32, device=dev)
        out = out.index_copy_(0, ids, v)    # ids are distinct
        return out.reshape(F, n_tables, k).permute(1, 0, 2).contiguous()

    return place(n_r), place(mean_r), place(m2_r), place(sx_r)


# --------------------------------------------------------------------------
# single-table surface
# --------------------------------------------------------------------------

def init(k: int, *, device=None) -> SKTable:
    """Empty K-centroid sketch ``{"sum_x": (K,), "y": Stats (K,)}`` on
    ``device`` (default ``cuda``)."""
    dev = dv.resolve(device)
    return {"sum_x": torch.zeros((k,), dtype=torch.float32, device=dev),
            "y": stats.init((k,), dev)}


def _planes(t: SKTable):
    return t["y"]["n"], t["y"]["mean"], t["y"]["m2"], t["sum_x"]


def _table(n, mean, m2, sum_x) -> SKTable:
    return {"sum_x": sum_x, "y": {"n": n, "mean": mean, "m2": m2}}


def _batch(x, y, w, dev):
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(-1)
    w = torch.ones_like(x) if w is None else \
        torch.as_tensor(w, dtype=torch.float32, device=dev).reshape(-1)
    return x, y, w


def from_batch(x, y, w=None, *, k: int, device=None) -> SKTable:
    """Sketch one weighted batch from scratch (single table)."""
    dev = dv.resolve(device)
    x, y, w = _batch(x, y, w, dev)
    leaf = torch.zeros(x.shape, dtype=torch.int64, device=dev)
    n, mean, m2, sum_x = from_batch_planes(leaf, x[:, None], y, w, 1, k)
    return _table(n[0, 0], mean[0, 0], m2[0, 0], sum_x[0, 0])


def merge(a: SKTable, b: SKTable) -> SKTable:
    """Merge two same-capacity sketches (:func:`merge_planes`)."""
    return _table(*merge_planes(*_planes(a), *_planes(b)))


def update(table: SKTable, x, y, w=None, *, device=None) -> SKTable:
    """Fold a weighted batch into the sketch: pre-sketch it at the table's
    capacity, then :func:`merge` (one compaction per batch)."""
    dev = dv.resolve(device)
    dv.check_on(table["sum_x"], dev, "table")
    return merge(table, from_batch(x, y, w, k=table["sum_x"].shape[-1],
                                   device=dev))


def best_split(table: SKTable, *, device=None) -> qo_query.SplitResult:
    """Variance-reduction best split over the sorted centroid boundaries:
    the QO query verbatim (a sorted centroid list is a sorted bin table)."""
    dv.check_on(table["sum_x"], dv.resolve(device), "table")
    n, mean, m2, sum_x = (a.contiguous() for a in
                          sort_planes(*_planes(table)))
    return qo_query.split(n, mean, m2, sum_x)


def quantile_sk(table: SKTable, q):
    """Approximate q-quantile(s) of the sketched x values, read off the
    centroid CDF."""
    n, _, _, sum_x = sort_planes(*_planes(table))
    return _filled_quantiles(n, prototypes(n, sum_x, empty=0.0), q)


def total_stats(table: SKTable) -> stats.Stats:
    """Whole-sample target statistics (merge of every centroid)."""
    return stats.tree_reduce_merge(table["y"], 0)


def n_slots(table: SKTable):
    """Occupied centroids -- the sketch's |H| memory metric."""
    return (table["y"]["n"] > 0).sum()
