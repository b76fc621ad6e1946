"""Online-bagged forest of QO Hoeffding tree regressors (the reference's
``core/forest.py``, DESIGN.md §5).

T member trees are one program over a leading tree axis: every routing
pass is one ``forest_route`` over the (T, M) node arrays, the absorb is
one ``forest_update`` (or, under the sketch observer, one
``sketch_update``) over the folded T*M table axis, and the split query
one compacted ``forest_best_splits`` over the attempting leaves of the
whole ensemble.  :func:`update` is the prequential step: predict the
batch with the inverse-error vote, learn it with Poisson(lambda) bagging
weights, then advance the per-member drift windows and swap out the
worst drifting member.

Random draws (ROADMAP C3): torch cannot reproduce JAX's threefry bits, so
:func:`update` takes optional injected ``bag_w`` (T, B) and ``new_masks``
(T, F).  Without them it draws from the state's own generator, whose
state rides in ``state["rng"]`` (a uint8 tensor) in place of the
reference's ``keys``; the same state and batch always give the same step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import device as dv
from repro_torch.core import hoeffding as ht
from repro_torch.core import stats
from repro_torch.kernels import leaf_stats as kleaf
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.perf.spans import count, span

ForestState = dict

__all__ = ["ForestConfig", "init_forest", "update", "update_stream",
           "predict", "member_predictions", "vote_weights", "vote_combine",
           "n_leaves_per_tree"]


@dataclass(frozen=True)
class ForestConfig:
    """Static forest hyper-parameters (the reference's ``ForestConfig``)."""
    tree: ht.HTRConfig
    n_trees: int = 8
    lam: float = 6.0
    subspace: float = 0.7
    vote: str = "inverse_error"
    vote_power: float = 4.0
    drift_alpha: float = 0.5
    drift_decay: float = 0.9
    drift_kappa: float = 3.0
    drift_min_batches: int = 8

    def __post_init__(self):
        if not 0.0 < self.drift_decay < 1.0:
            raise ValueError(
                f"drift_decay={self.drift_decay} must be in (0, 1): it is "
                f"the per-batch retention of the long window's count")
        limit = 1.0 / (1.0 - self.drift_decay)
        if self.drift_min_batches >= limit:
            raise ValueError(
                f"drift_min_batches={self.drift_min_batches} can never be "
                f"reached: the decayed window's effective count asymptotes "
                f"to 1/(1-drift_decay)={limit:.1f}")
        if self.tree.n_features >= 2 and self.subspace_k() < 2:
            raise ValueError(
                f"subspace={self.subspace} leaves each member a single "
                f"candidate feature; raise subspace so k >= 2")
        if self.vote not in ("mean", "inverse_error"):
            raise ValueError(f"vote={self.vote!r}: expected 'mean' or "
                             f"'inverse_error'")

    def subspace_k(self) -> int:
        return max(1, int(round(self.subspace * self.tree.n_features)))


def _poisson_cdf(lam: float, tail: float = 1e-7):
    """Static inverse-CDF table: [P(X<=0), P(X<=1), ...] up to 1-tail."""
    cdf, p, k, c = [], math.exp(-lam), 0, math.exp(-lam)
    while c < 1.0 - tail and k < 64:
        cdf.append(c)
        k += 1
        p *= lam / k
        c += p
    cdf.append(c)
    return cdf


def _poisson_weights(gen, cdf, shape, dev):
    """Poisson draw by inverse-CDF table lookup: X = #{k : u >= P(X<=k)}."""
    u = torch.rand(shape, generator=gen, device=dev)
    return (u[..., None] >= cdf).sum(-1).to(torch.float32)


def _draw_masks(gen, T: int, F: int, k: int, dev):
    """(T, F) bool: k features per tree, drawn as the first k of a random
    permutation (argsort of uniforms, one call for all trees)."""
    perm = torch.argsort(torch.rand((T, F), generator=gen, device=dev), 1)
    mask = torch.zeros((T, F), dtype=torch.bool, device=dev)
    return mask.scatter_(1, perm[:, :k], True)


def _generator(state_rng, dev):
    gen = torch.Generator(device=dev)
    gen.set_state(state_rng)
    return gen


def _fresh_trees(cfg: ForestConfig, T: int, dev):
    base = ht.init_state(cfg.tree, device=dev)
    expand = lambda a: a[None].expand((T,) + a.shape).clone()
    return {k: ({kk: expand(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else expand(v))
            for k, v in base.items()}


def init_forest(cfg: ForestConfig, seed: int = 0, *, device=None,
                feat_mask=None) -> ForestState:
    """Fresh forest state; every leaf carries the tree axis first.

    ``trees`` (stacked tree states), ``feat_mask`` (T, F) bool, ``rng``
    (the generator state that replaces the reference's ``keys``),
    ``err_win`` Stats (T,), ``err_ewma`` (T,), ``vote_w`` (T,),
    ``resets`` (T,) i32.  ``feat_mask`` may be injected (C3); otherwise it
    is drawn from a generator seeded with ``seed``.
    """
    dev = dv.resolve(device)
    T, F = cfg.n_trees, cfg.tree.n_features
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    masks = _draw_masks(gen, T, F, cfg.subspace_k(), dev) \
        if feat_mask is None else \
        torch.as_tensor(feat_mask, dtype=torch.bool, device=dev)
    return {
        "trees": _fresh_trees(cfg, T, dev),
        "feat_mask": masks,
        "rng": gen.get_state(),
        "err_win": stats.init((T,), dev),
        "err_ewma": torch.zeros((T,), dtype=torch.float32, device=dev),
        "vote_w": torch.zeros((T,), dtype=torch.float32, device=dev),
        "resets": torch.zeros((T,), dtype=torch.int32, device=dev),
    }


def _route_all(cfg: ForestConfig, trees, X):
    """(T, B) leaf ids: one route of every tree, bounded by ``max_depth``
    (a row stops at its leaf, so no host read of the realized depth); the
    oracle engine walks each member with the scalar route."""
    if cfg.tree.split_backend == "oracle":
        return kref.forest_route_ref(trees["feature"], trees["threshold"],
                                     trees["child"], trees["is_leaf"], X,
                                     cfg.tree.max_depth)
    return kops.forest_route(trees["feature"], trees["threshold"],
                             trees["child"], trees["is_leaf"], X,
                             depth=cfg.tree.max_depth)


def _member_predictions(cfg: ForestConfig, trees, X):
    leaf = _route_all(cfg, trees, X)
    return torch.gather(trees["ystats"]["mean"], 1, leaf.long())


def member_predictions(cfg: ForestConfig, state: ForestState, X, *,
                       device=None):
    """(T, B) f32: every member's prediction for every row of X (B, F)."""
    dev = dv.resolve(device)
    dv.check_on(state["vote_w"], dev, "state")
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    return _member_predictions(cfg, state["trees"], X)


def vote_weights(cfg: ForestConfig, state: ForestState):
    """(T,) f32 un-normalized member vote weights from the error windows."""
    T = state["err_ewma"].shape[0]
    if cfg.vote == "mean":
        return torch.ones((T,), dtype=torch.float32,
                          device=state["err_ewma"].device)
    seen = state["err_win"]["n"] > 0
    return torch.where(
        seen, (1.0 / (state["err_ewma"] + 1e-6)) ** cfg.vote_power, 0.0)


def vote_combine(yhat, wts, group=None):
    """(T, B) member predictions + (T,) weights -> (B,) vote.  The one
    definition of the prediction reduce, shared by :func:`predict`, the
    prequential error in :func:`update` and snapshot serving.  With a
    ``torch.distributed`` ``group`` (the tree axis split over its ranks)
    the (num, den) pair is all-reduced over it: the forest's only
    collective."""
    num = (wts[:, None] * yhat).sum(0)
    den = wts.sum()
    if group is not None:
        import torch.distributed as dist
        pair = torch.cat([num, den[None]])
        dist.all_reduce(pair, group=group)
        num, den = pair[:-1], pair[-1]
    return num / torch.clamp(den, min=1e-12)


def predict(cfg: ForestConfig, state: ForestState, X, *, device=None,
            group=None):
    """(B,) f32 forest prediction: the vote-weighted mean of members.
    ``group``: the ranks the tree axis is split over (see
    :func:`vote_combine`)."""
    return vote_combine(member_predictions(cfg, state, X, device=device),
                        state["vote_w"], group)


def _fold(a, T, M):
    return a.reshape((T * M,) + a.shape[2:])


def _fused_route_sort(cfg: ForestConfig, trees, X):
    """Route all T members and sort the batch by folded leaf id.

    One route of all T trees and one sort of the global leaf ids ``t*M +
    leaf``.  Returns ``(gl, leaf, rows)``: the (T*B,) folded ids, the
    (T, B) per-tree ids and the ``(order, offsets)`` of the sort, which
    the target statistics and the absorb walk."""
    T, M = trees["feature"].shape
    with span("forest.route"):
        leaf = _route_all(cfg, trees, X)
    with span("forest.stats"):
        gl = (torch.arange(T, dtype=torch.int32, device=X.device)[:, None]
              * M + leaf).reshape(-1)
        rows = kops.sort_rows(gl, T * M)
    return gl, leaf, rows


def _fused_route_stats(cfg: ForestConfig, trees, X, y, w):
    """:func:`_fused_route_sort`, then one flat segment reduction of the
    batch's per-leaf target stats.  w: (T, B).  Returns ``(gl, leaf,
    batch_leaf, rows)``, ``batch_leaf`` the (T, M) Stats of the batch: the
    shard-local quantities of the data-parallel protocol, which
    accumulates them in a delta instead of the trees."""
    T, M = trees["feature"].shape
    gl, leaf, rows = _fused_route_sort(cfg, trees, X)
    with span("forest.stats"):
        batch_leaf = ht.segment_stats(y.repeat(T), gl, T * M, w.reshape(-1),
                                      rows)
    return (gl, leaf, {k: v.reshape(T, M) for k, v in batch_leaf.items()},
            rows)


def _fused_absorb_tables(cfg: ForestConfig, ao_y, ao_sum_x, trees, gl,
                         X, y, w, rows=None):
    """Absorb a routed batch into ANY (T, M, F, C) table set in one pass.

    ``ao_y``/``ao_sum_x`` are the target (the trees' own tables, or a
    shard's delta); the quantization grid (radius, origin) always comes
    from ``trees``, so every shard bins alike and the deltas stay
    mergeable.  gl: (T*B,) folded ids and rows their sort, both from
    :func:`_fused_route_sort`; w: (T, B).  Returns ``(ao_y, ao_sum_x)``:
    the QO tables are updated in place and returned; under the sketch
    observer new planes."""
    T, M = trees["feature"].shape
    flat = lambda a: _fold(a, T, M)
    with span("forest.absorb"):
        if cfg.tree.observer_backend == "sketch":
            # the sketch needs no quantization grid: the folded leaf ids
            # alone segment the batch
            fy, fsx = kops.sketch_update(
                {k: flat(v) for k, v in ao_y.items()}, flat(ao_sum_x), gl, X,
                y, w.reshape(-1))
            unflat = lambda a: a.reshape((T, M) + a.shape[1:])
            return {k: unflat(v) for k, v in fy.items()}, unflat(fsx)
        kops.forest_update({k: flat(v) for k, v in ao_y.items()},
                           flat(ao_sum_x), flat(trees["ao_radius"]),
                           flat(trees["ao_origin"]), gl, X, y, w.reshape(-1),
                           rows=rows)
        return ao_y, ao_sum_x


def _learn(cfg: ForestConfig, trees, feat_mask, X, y, w):
    """All T member updates as one flat pass: route, per-leaf target stats
    (``kernels/leaf_stats.py``; in place on the card), absorb (QO tables
    in place; sketch planes rebound), attempt (``ht.attempt_trees``, which
    the data-parallel sync runs on merged statistics).  w: (T, B) sample
    weights.  Returns ``(trees, ids)``: ``ids`` is ``(flags, gl, T*M)``
    for :func:`_any_drift`, whose read checks the step's leaf ids, or None
    under the oracle engine, which runs the members one at a time through
    ``hoeffding.update`` instead, as the reference's
    ``vmap(hoeffding.update)``."""
    if cfg.tree.split_backend == "oracle":
        T = w.shape[0]
        members = [ht.update(cfg.tree,
                             {k: ({kk: vv[t] for kk, vv in v.items()}
                                  if isinstance(v, dict) else v[t])
                              for k, v in trees.items()},
                             X, y, w[t], feat_mask[t], device=X.device)
                   for t in range(T)]
        return {k: ({kk: torch.stack([m[k][kk] for m in members])
                     for kk in v} if isinstance(v, dict)
                    else torch.stack([m[k] for m in members]))
                for k, v in trees.items()}, None
    T, M = trees["feature"].shape
    gl, _, rows = _fused_route_sort(cfg, trees, X)
    # [drift.any(), ids out of range]: one host read carries both
    flags = torch.empty(2, dtype=torch.bool, device=X.device)
    with span("forest.stats"):
        ystats, seen = kleaf.leaf_stats(
            {k: v.reshape(-1) for k, v in trees["ystats"].items()},
            trees["seen_since_attempt"].reshape(-1), gl, y, w.reshape(-1),
            rows, flags[1:])
        if X.is_cuda:
            count("forest.leaf_stats")
        trees = dict(trees,
                     ystats={k: v.reshape(T, M) for k, v in ystats.items()},
                     seen_since_attempt=seen.reshape(T, M))
    ao_y, ao_sum_x = _fused_absorb_tables(cfg, trees["ao_y"],
                                          trees["ao_sum_x"], trees, gl, X, y,
                                          w, rows)
    trees = dict(trees, ao_y=ao_y, ao_sum_x=ao_sum_x)
    return ht.attempt_trees(cfg.tree, trees, feat_mask), (flags, gl, T * M)


def _any_drift(drift, ids) -> bool:
    """``bool(drift.any())``, the step's one host read.  With ``ids``
    (``(flags, gl, n)`` from :func:`_learn`) the same read carries the
    target statistics' check of the folded leaf ids, ``flags[1]``: a
    two-element read in place of one, and a RuntimeError naming the ids
    outside [0, n)."""
    if ids is None:
        return bool(drift.any())
    flags, gl, n = ids
    torch.any(drift, 0, keepdim=True, out=flags[:1])
    swaps, bad = flags.tolist()
    if bad:
        raise kleaf.out_of_range(gl, n)
    return swaps


def update(cfg: ForestConfig, state: ForestState, X, y, w=None, *,
           bag_w=None, new_masks=None, device=None, group=None):
    """Learn one batch, test-then-train.

    X: (B, F); y: (B,); w: optional (B,) row weights (multiply every
    member's bagging draw and weight the prequential errors).  ``bag_w``
    (T, B) and ``new_masks`` (T, F) inject the bagging weights and the
    subspace masks a swapped member would get (C3); without them they
    are drawn from ``state["rng"]``.

    Returns ``(state, aux)`` with ``aux = {"member_mse": (T,),
    "forest_mse": (), "drift": (T,) bool}``, the prequential (pre-update)
    errors of this batch.  The QO tables of ``state`` are updated in
    place: the old state is consumed.

    ``group``: the ``torch.distributed`` ranks the tree axis is split over
    (each rank's ``state`` holds its own members, T taken from the state):
    only the forest vote is all-reduced, and the drift swap is resolved
    among the rank's members.
    """
    with span("forest.update"):
        count("forest.steps")
        return _update(cfg, state, X, y, w, bag_w, new_masks, device, group)


def _update(cfg, state, X, y, w, bag_w, new_masks, device, group):
    """:func:`update`'s body, one profiler span per stage."""
    dev = dv.resolve(device)
    dv.check_on(state["vote_w"], dev, "state")
    X, y, row_w = ht.as_batch(X, y, w, dev)
    B = y.shape[0]
    T, F = state["vote_w"].shape[0], cfg.tree.n_features
    wsum = torch.clamp(row_w.sum(), min=1e-12)

    # --- test: prequential member + forest errors on the raw stream ------
    with span("forest.predict"):
        yhat = _member_predictions(cfg, state["trees"], X)       # (T, B)
        member_mse = (row_w[None, :] * (yhat - y[None, :]) ** 2).sum(1) \
            / wsum
        fpred = vote_combine(yhat, state["vote_w"], group)
        forest_mse = (row_w * (fpred - y) ** 2).sum() / wsum

    # --- train: Poisson(lambda) bagging weights, one fused member update --
    with span("forest.bag"):
        gen = _generator(state["rng"], dev)
        if bag_w is None:
            cdf = torch.tensor(_poisson_cdf(cfg.lam), dtype=torch.float32,
                               device=dev)
            bag_w = _poisson_weights(gen, cdf, (T, B), dev)
        else:
            bag_w = torch.as_tensor(bag_w, dtype=torch.float32, device=dev)
        if new_masks is None:
            new_masks = _draw_masks(gen, T, F, cfg.subspace_k(), dev)
        else:
            new_masks = torch.as_tensor(new_masks, dtype=torch.bool,
                                        device=dev)
        w_learn = bag_w * row_w[None, :]
    trees, ids = _learn(cfg, state["trees"], state["feat_mask"], X, y,
                        w_learn)

    # --- drift: ADWIN-style short-vs-long window test per member ---------
    # compared BEFORE this batch folds into the long window; both windows
    # advance by the batch's real-row fraction
    with span("forest.drift"):
        live = row_w.sum() > 0
        frac = torch.where(live, torch.clamp(wsum / max(float(B), 1.0),
                                             max=1.0), 0.0)
        alpha = cfg.drift_alpha * frac
        first = (state["err_win"]["n"] < 0.5) & live
        ewma = torch.where(first, member_mse,
                           (1.0 - alpha) * state["err_ewma"]
                           + alpha * member_mse)
        ref = state["err_win"]
        sd = torch.sqrt(torch.clamp(stats.variance(ref), min=1e-12))
        signal = (ref["n"] >= cfg.drift_min_batches) \
            & (ewma > ref["mean"] + cfg.drift_kappa * sd)
        # swap at most the WORST signalling member per batch
        worst = torch.argmax(torch.where(signal, ewma, float("-inf")))
        drift = signal & (torch.arange(T, device=dev) == worst)
        decay_f32 = torch.tensor(cfg.drift_decay, dtype=torch.float32,
                                 device=dev)
        decay = torch.where(frac >= 1.0, decay_f32, decay_f32 ** frac)
        decayed = {"n": decay * ref["n"], "mean": ref["mean"],
                   "m2": decay * ref["m2"]}
        observed = stats.observe(decayed, member_mse, frac)
        # a signalling member's reference freezes (no decay, no observe)
        win = {k: torch.where(signal, ref[k], observed[k]) for k in observed}
        swaps = _any_drift(drift, ids)  # host branch: most batches swap nobody

    # --- swap: reset the drifting member (fresh tree, subspace, window) --
    feat_mask = state["feat_mask"]
    if swaps:
        count("forest.swaps")
        with span("forest.swap"):
            fresh = _fresh_trees(cfg, T, dev)

            def swap(a, f):
                return torch.where(
                    drift.reshape((T,) + (1,) * (a.dim() - 1)), f, a)
            trees = {k: ({kk: swap(vv, fresh[k][kk]) for kk, vv in v.items()}
                         if isinstance(v, dict) else swap(v, fresh[k]))
                     for k, v in trees.items()}
            feat_mask = torch.where(drift[:, None], new_masks, feat_mask)
    with span("forest.vote"):
        state = {
            "trees": trees,
            "feat_mask": feat_mask,
            "rng": gen.get_state(),
            "err_win": {k: torch.where(drift, 0.0, v)
                        for k, v in win.items()},
            "err_ewma": torch.where(drift, 0.0, ewma),
            "resets": state["resets"] + drift.to(torch.int32),
        }
        # vote weights refresh ONCE per learned batch
        state["vote_w"] = vote_weights(cfg, state)
    return state, {"member_mse": member_mse, "forest_mse": forest_mse,
                   "drift": drift}


def update_stream(cfg: ForestConfig, state: ForestState, X, y,
                  batch_size: int = 256, *, device=None):
    """Learn a stream batch by batch (a Python loop in place of the
    reference's ``lax.scan``); the ragged tail rides at weight 0.
    Returns ``(state, trace)`` with the (n_batches,) ``forest_mse`` and
    (n_batches, T) ``member_mse`` traces."""
    fm, mm = [], []
    for Xb, yb, wb in zip(*ht.pad_stream(X, y, None, batch_size)):
        state, aux = update(cfg, state, Xb, yb, wb, device=device)
        fm.append(aux["forest_mse"])
        mm.append(aux["member_mse"])
    return state, {"forest_mse": torch.stack(fm),
                   "member_mse": torch.stack(mm)}


def n_leaves_per_tree(state: ForestState) -> torch.Tensor:
    """(T,) i32 live-leaf count of every member (diagnostics)."""
    return ht._live_leaves(state["trees"]).sum(-1, dtype=torch.int32)
