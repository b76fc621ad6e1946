"""Batched online Hoeffding tree regressor with QO attribute observers.

The port of the reference's ``core/hoeffding.py``.  A tree is a dict of
fixed-capacity tensors with the reference's key names, and one learned
batch runs three stages:

* **route**   -- leaf id per row (:func:`repro_torch.kernels.ops.route`);
* **absorb**  -- every (leaf, feature) QO table folds the batch in, in
  place (:func:`repro_torch.kernels.ops.forest_update`), or, under
  ``observer_backend="sketch"``, every K-centroid sketch is re-compacted
  with the batch into new planes
  (:func:`repro_torch.kernels.ops.sketch_update`);
* **attempt** -- the K attempting leaves are queried
  (:func:`repro_torch.kernels.ops.forest_best_splits`), decided
  (:mod:`repro_torch.core.decide`) and split.

The attempt stage works on a leading tree axis (T, M, ...), so the forest
(:mod:`repro_torch.core.forest`) and the single tree (T = 1) share one
implementation, as the reference shares it through ``vmap``.  JAX's
dropped scatters (``.at[M].set(..., mode="drop")``) become explicit masks:
only the leaves that split, and their children, are written (ROADMAP C4).

Host reads, each a sync, accepted in this first slice: the realized
depth that trims the routing sweep, ``attempt.any()`` (the reference's
``lax.cond``), the compacted query's K and the list of splitting leaves
(``bincount`` and ``segment_reduce`` in the index bookkeeping add more).

QO tables (``ao_y``, ``ao_sum_x``) are updated IN PLACE: ``update``
consumes the state it is given (under the sketch the absorb rebinds new
planes, but the attempt stage still zeroes the new children's in place).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch import device as dv
from repro_torch.core import decide as dc
from repro_torch.core import stats
from repro_torch.kernels import ops as kops

TreeState = Dict[str, object]

__all__ = ["HTRConfig", "init_state", "update", "update_local",
           "attempt_splits", "pad_stream", "predict", "attempt_mask",
           "attempt_trees", "segment_stats"]


@dataclass(frozen=True)
class HTRConfig:
    n_features: int
    max_nodes: int = 127          # total capacity (internal + leaves)
    n_bins: int = 64              # QO table capacity per (leaf, feature)
    grace_period: int = 200       # observations between split attempts
    delta: float = 1e-4           # Hoeffding confidence
    tau: float = 0.05             # tie-break threshold
    max_depth: int = 12
    r0: float = 0.05              # cold-start quantization radius (paper §5.2)
    sigma_k: float = 2.0          # dynamic radius r = sigma / k for children
    split_backend: str = "auto"   # the tensors' device picks kernel or plain
    attempt_schedule: str = "grace"   # grace | eager
    decision_backend: str = "hoeffding"   # hoeffding | anytime
    alpha: float = 0.05           # anytime-valid false-split level
    # attribute-observer layout: "qo" keeps the dense (M, F, C) bin
    # planes (C = n_bins); "sketch" keeps K = sketch_k rank-bucket
    # centroids per (leaf, feature) in the same four planes
    observer_backend: str = "qo"  # qo | sketch
    sketch_k: int = 16            # sketch capacity K (slots per table)

    def observer_bins(self) -> int:
        """Slot count of the observer's last table axis: ``n_bins`` under
        the dense layout, ``sketch_k`` centroids under the sketch."""
        return self.n_bins if self.observer_backend == "qo" else self.sketch_k

    def __post_init__(self):
        if self.observer_backend not in ("qo", "sketch"):
            raise ValueError(
                f"observer_backend={self.observer_backend!r}: expected "
                f"'qo' (dense bins) or 'sketch' (rank-bucket centroids)")
        if self.observer_backend == "sketch" and \
                self.split_backend == "oracle":
            raise ValueError(
                "observer_backend='sketch' has no oracle engine: the seed "
                "path quantizes into dense bins")
        if self.sketch_k < 2:
            raise ValueError(f"sketch_k={self.sketch_k}: need >= 2 slots "
                             f"for a split boundary to exist")
        if self.split_backend == "oracle":
            raise NotImplementedError(
                "split_backend='oracle' (the seed engine) is not ported yet: "
                "ROADMAP A13")
        if self.split_backend != "auto":
            raise ValueError(
                f"split_backend={self.split_backend!r}: the port takes only "
                f"'auto' (the tensors' device selects kernel or plain)")
        if self.attempt_schedule not in ("grace", "eager"):
            raise ValueError(
                f"attempt_schedule={self.attempt_schedule!r}: expected "
                f"'grace' or 'eager'")
        if self.decision_backend not in dc.DECISION_BACKENDS:
            raise ValueError(
                f"decision_backend={self.decision_backend!r}: expected "
                f"one of {dc.DECISION_BACKENDS}")
        if not 0.0 < self.alpha < 1.0:
            raise ValueError(f"alpha={self.alpha}: expected 0 < alpha < 1")


def init_state(cfg: HTRConfig, *, device=None) -> TreeState:
    """Empty single-root tree on ``device`` (default ``cuda``).

    Keys, shapes and dtypes are the reference's: ``feature`` (M,) i32,
    ``threshold`` (M,) f32, ``child`` (M, 2) i32, ``is_leaf`` (M,) bool,
    ``depth`` (M,) i32, ``ystats`` Stats (M,), ``ao_sum_x`` (M, F, C),
    ``ao_y`` Stats (M, F, C), ``ao_radius`` / ``ao_origin`` (M, F),
    ``seen_since_attempt`` (M,), ``dec_logE`` (M, F), ``dec_n_last`` (M,),
    ``n_nodes`` () i32; C = ``cfg.observer_bins()`` (``ao_radius`` and
    ``ao_origin`` ride inert under the sketch).
    """
    dev = dv.resolve(device)
    M, F, C = cfg.max_nodes, cfg.n_features, cfg.observer_bins()
    f32 = dict(dtype=torch.float32, device=dev)
    is_leaf = torch.zeros((M,), dtype=torch.bool, device=dev)
    is_leaf[0] = True
    return {
        "feature": torch.zeros((M,), dtype=torch.int32, device=dev),
        "threshold": torch.zeros((M,), **f32),
        "child": torch.full((M, 2), -1, dtype=torch.int32, device=dev),
        "is_leaf": is_leaf,
        "depth": torch.zeros((M,), dtype=torch.int32, device=dev),
        "ystats": stats.init((M,), dev),
        "ao_sum_x": torch.zeros((M, F, C), **f32),
        "ao_y": stats.init((M, F, C), dev),
        "ao_radius": torch.full((M, F), cfg.r0, **f32),
        "ao_origin": torch.zeros((M, F), **f32),
        "seen_since_attempt": torch.zeros((M,), **f32),
        **dc.decision_state(M, F, dev),
        "n_nodes": torch.tensor(1, dtype=torch.int32, device=dev),
    }


def as_batch(X, y, w, dev):
    """(B, F) X, (B,) y and w as float32 tensors on ``dev``."""
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(-1)
    w = torch.ones_like(y) if w is None else \
        torch.as_tensor(w, dtype=torch.float32, device=dev).reshape(-1)
    return X.contiguous(), y.contiguous(), w.contiguous()


def realized_depth(cfg: HTRConfig, depth) -> int:
    """Deepest node of the state, capped at ``max_depth`` (one host read):
    routing more plies than this only repeats leaf self-loops."""
    return min(cfg.max_depth, int(depth.max()))


def _route(cfg: HTRConfig, state: TreeState, X):
    return kops.route(state["feature"], state["threshold"], state["child"],
                      state["is_leaf"], X,
                      depth=realized_depth(cfg, state["depth"]))


def predict(cfg: HTRConfig, state: TreeState, X, *, device=None):
    """(B,) f32 leaf-mean predictions for X (B, F)."""
    dev = dv.resolve(device)
    dv.check_on(state["feature"], dev, "state")
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    leaf = _route(cfg, state, X)
    return state["ystats"]["mean"][leaf.long()]


def segment_stats(vals_y, seg, num: int, w, rows=None):
    """Exact per-segment weighted (n, mean, M2) with the two-pass residual
    M2.  Rows are ordered by segment (stable sort) and each sum runs over
    one segment's contiguous run, so the result does not depend on
    atomics (bitwise repeatable on the card).  ``rows``: the ``(order,
    offsets)`` of ``kops.sort_rows(seg, num)`` when the caller has sorted
    already.  A segment id outside [0, num) raises: the runs then cover
    fewer rows than there are, which ``segment_reduce``'s own length
    check refuses (no host read besides its own)."""
    order, offsets = kops.sort_rows(seg, num) if rows is None else rows
    order = order.long()
    lengths = offsets[1:] - offsets[:-1]
    ws, ys = w[order], vals_y[order]
    n = torch.segment_reduce(ws, "sum", lengths=lengths)
    sy = torch.segment_reduce(ws * ys, "sum", lengths=lengths)
    safe = torch.where(n > 0, n, 1.0)
    mean = torch.where(n > 0, sy / safe, 0.0)
    m2 = torch.segment_reduce(ws * (ys - mean[seg[order].long()]) ** 2,
                              "sum", lengths=lengths)
    return {"n": n, "mean": mean, "m2": torch.where(n > 0, m2, 0.0)}


def attempt_mask(cfg: HTRConfig, state: TreeState):
    """(..., M) bool: which leaves attempt a split this batch (§2.5)."""
    if cfg.attempt_schedule == "grace":
        mature = state["seen_since_attempt"] >= cfg.grace_period
    else:  # "eager"
        mature = state["ystats"]["n"] >= cfg.grace_period
    return state["is_leaf"] & mature & (state["depth"] < cfg.max_depth)


def _child_radius(cfg: HTRConfig, occ, sum_x):
    """Child radius sigma_x / k and origin mean_x of the given parent rows'
    (P, F, C) tables (paper §5.2)."""
    nb = torch.clamp(occ, min=1.0)
    proto = torch.where(occ > 0, sum_x / nb, 0.0)
    n_f = occ.sum(-1)
    mean_x = (occ * proto).sum(-1) / torch.clamp(n_f, min=1.0)
    var_x = (occ * (proto - mean_x[..., None]) ** 2).sum(-1) \
        / torch.clamp(n_f - 1.0, min=1.0)
    sigma = torch.sqrt(torch.clamp(var_x, min=1e-12))
    child_r = torch.clamp(sigma / cfg.sigma_k, min=1e-6)
    return child_r, mean_x


def _side(mask, nw, mean_b, m2_b):
    """Grouped two-pass stats of the masked bins (Eqs. 6-7 algebra)."""
    nn = (mask * nw).sum(-1)
    sy = (mask * (nw * mean_b)).sum(-1)
    mean = torch.where(nn > 0, sy / torch.where(nn > 0, nn, 1.0), 0.0)
    m2 = (mask * m2_b).sum(-1) + \
        (mask * nw * (mean_b - mean[:, None]) ** 2).sum(-1)
    return {"n": nn, "mean": mean, "m2": torch.where(nn > 0, m2, 0.0)}


def _apply_splits(cfg: HTRConfig, trees, merit, thr_all, attempt,
                  feat_mask=None):
    """Decision + child allocation + writes for a (T, M) batch of trees.

    merit/thr_all: (T, M, F) query results; attempt: (T, M) bool;
    feat_mask: optional (T, F) bool.  Small per-node arrays are copied
    before they are written; the QO tables of the new children are zeroed
    in place."""
    T, M = attempt.shape
    want, best_f, dec_new = dc.decide(cfg, trees, merit, attempt, feat_mask)
    best_c = torch.gather(thr_all, -1, best_f[..., None])[..., 0]
    # vectorized allocation of 2 children per splitting leaf
    k = torch.cumsum(want.to(torch.int32), -1, dtype=torch.int32) - 1
    base = trees["n_nodes"][:, None] + 2 * k
    can = want & (base + 1 < M)
    pt, pm = torch.nonzero(can, as_tuple=True)        # the leaves that split
    c0 = base[pt, pm].long()
    kt, km = torch.cat([pt, pt]), torch.cat([c0, c0 + 1])   # their children

    st = dict(trees, **dec_new)

    def put(name, *writes):
        a = st[name].clone()
        for t_idx, m_idx, v in writes:
            a[t_idx, m_idx] = v
        st[name] = a

    put("feature", (pt, pm, best_f[pt, pm].to(torch.int32)))
    put("threshold", (pt, pm, best_c[pt, pm]))
    put("child", (pt, pm, torch.stack([c0, c0 + 1], 1).to(torch.int32)),
        (kt, km, -1))
    put("is_leaf", (pt, pm, False), (kt, km, True))
    put("seen_since_attempt", (pt, pm, 0.0), (kt, km, 0.0))
    put("depth", (kt, km, (trees["depth"][pt, pm] + 1).repeat(2)))
    # fresh e-processes for the children; the split parent's are retired
    put("dec_logE", (pt, pm, 0.0), (kt, km, 0.0))
    put("dec_n_last", (pt, pm, 0.0), (kt, km, 0.0))

    # children inherit the split halves' target statistics, recovered from
    # the winning feature's QO bins with the grouped two-pass form
    ao_y, ao_sum_x = trees["ao_y"], trees["ao_sum_x"]
    bf = best_f[pt, pm]
    n_f = ao_y["n"][pt, pm, bf]                                   # (P, C)
    sumx_f = ao_sum_x[pt, pm, bf]
    occ_f = n_f > 0
    proto_f = torch.where(occ_f, sumx_f / torch.where(occ_f, n_f, 1.0),
                          float("inf"))
    maskL = (occ_f & (proto_f <= best_c[pt, pm][:, None])).to(torch.float32)
    maskR = occ_f.to(torch.float32) - maskL
    mean_f, m2_f = ao_y["mean"][pt, pm, bf], ao_y["m2"][pt, pm, bf]
    left = _side(maskL, n_f, mean_f, m2_f)
    right = _side(maskR, n_f, mean_f, m2_f)
    ystats = {}
    for key in ("n", "mean", "m2"):
        a = trees["ystats"][key].clone()
        a[kt, km] = torch.cat([left[key], right[key]])
        ystats[key] = a
    st["ystats"] = ystats

    child_r, mean_x = _child_radius(cfg, ao_y["n"][pt, pm],
                                    ao_sum_x[pt, pm])
    put("ao_radius", (kt, km, child_r.repeat(2, 1)))
    put("ao_origin", (kt, km, mean_x.repeat(2, 1)))
    for plane in (ao_y["n"], ao_y["mean"], ao_y["m2"], ao_sum_x):
        plane[kt, km] = 0.0

    st["n_nodes"] = trees["n_nodes"] + 2 * can.sum(-1, dtype=torch.int32)
    # failed attempts still reset the grace counter
    st["seen_since_attempt"] = torch.where(attempt & ~can, 0.0,
                                           st["seen_since_attempt"])
    return st


def attempt_trees(cfg: HTRConfig, trees, feat_mask=None):
    """Attempt stage of a (T, M) batch of trees on their current stats:
    the scheduling mask plus the capacity gate, ONE compacted query over
    the folded T*M table axis, then the decision and the writes."""
    T, M = trees["is_leaf"].shape
    F = cfg.n_features
    attempt = attempt_mask(cfg, trees) & (trees["n_nodes"][:, None] + 1 < M)
    if not bool(attempt.any()):   # host branch: the reference's lax.cond
        return trees
    fold = lambda a: a.reshape((T * M,) + a.shape[2:])
    ao_y = {k: fold(v) for k, v in trees["ao_y"].items()}
    ao_sum_x = fold(trees["ao_sum_x"])
    if cfg.observer_backend == "sketch":
        # sorted centroids ARE a sorted bin table: the QO query, the
        # decision and the writes ride unchanged over the K-slot planes
        ao_y, ao_sum_x = kops.sketch_to_bins(ao_y, ao_sum_x)
    merit, thr = kops.forest_best_splits(ao_y, ao_sum_x, attempt.reshape(-1))
    return _apply_splits(cfg, trees, merit.reshape(T, M, F),
                         thr.reshape(T, M, F), attempt, feat_mask)


def _lift(state):
    """Single tree -> a batch of one (views, so in-place writes carry)."""
    return {k: ({kk: vv[None] for kk, vv in v.items()}
                if isinstance(v, dict) else v[None])
            for k, v in state.items()}


def _drop(trees):
    return {k: ({kk: vv[0] for kk, vv in v.items()}
                if isinstance(v, dict) else v[0])
            for k, v in trees.items()}


def update_local(cfg: HTRConfig, state: TreeState, X, y, w=None, *,
                 device=None) -> TreeState:
    """Route + absorb, no attempts (the reference's ``update_local``)."""
    dev = dv.resolve(device)
    dv.check_on(state["feature"], dev, "state")
    X, y, w = as_batch(X, y, w, dev)
    M = cfg.max_nodes
    leaf = _route(cfg, state, X)                                   # (B,)
    rows = kops.sort_rows(leaf, M)      # one sort: stats and absorb share it
    batch_leaf = segment_stats(y, leaf, M, w, rows)
    state = dict(state,
                 ystats=stats.merge(state["ystats"], batch_leaf),
                 seen_since_attempt=state["seen_since_attempt"]
                 + batch_leaf["n"])
    if cfg.observer_backend == "sketch":
        ao_y, ao_sum_x = kops.sketch_update(state["ao_y"], state["ao_sum_x"],
                                            leaf, X, y, w)
        return dict(state, ao_y=ao_y, ao_sum_x=ao_sum_x)
    kops.forest_update(state["ao_y"], state["ao_sum_x"], state["ao_radius"],
                       state["ao_origin"], leaf, X, y, w, rows=rows)
    return state


def attempt_splits(cfg: HTRConfig, state: TreeState, feat_mask=None, *,
                   device=None) -> TreeState:
    """Evaluate and apply the due splits (the reference's
    ``attempt_splits``).  ``feat_mask``: optional (F,) bool subspace."""
    dev = dv.resolve(device)
    dv.check_on(state["feature"], dev, "state")
    fm = None if feat_mask is None else \
        torch.as_tensor(feat_mask, dtype=torch.bool, device=dev)[None]
    return _drop(attempt_trees(cfg, _lift(state), fm))


def update(cfg: HTRConfig, state: TreeState, X, y, w=None, feat_mask=None,
           *, device=None) -> TreeState:
    """Learn one batch: route, absorb, attempt splits."""
    return attempt_splits(cfg, update_local(cfg, state, X, y, w,
                                            device=device),
                          feat_mask, device=device)


def pad_stream(X, y, w=None, batch_size: int = 256):
    """Chunk a stream into (n_batches, batch_size, ...) with a weight-0
    tail (the reference's ``pad_stream``); numpy in, numpy out."""
    import numpy as np
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32).reshape(-1)
    w = np.ones_like(y) if w is None else np.asarray(w, np.float32).reshape(-1)
    pad = (-X.shape[0]) % batch_size
    if pad:
        X = np.concatenate([X, np.zeros((pad, X.shape[1]), np.float32)])
        y = np.concatenate([y, np.zeros((pad,), np.float32)])
        w = np.concatenate([w, np.zeros((pad,), np.float32)])
    return (X.reshape(-1, batch_size, X.shape[1]),
            y.reshape(-1, batch_size), w.reshape(-1, batch_size))

