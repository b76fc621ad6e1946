"""Data-parallel stream training (the batch-axis half of the reference's
``train/sharding.py``, DESIGN.md §4.1).

The training stream is sharded over D shards.  Every shard holds a
replicated copy of the forest (topology, quantization grids, merged
statistics) and a private *delta*: the target Stats, QO tables and
prequential errors absorbed since the last sync.  A local step routes
the shard's rows through the replicated trees and absorbs them into its
delta; it never writes the forest and attempts no split.  Every
``sync_every`` global batches the D deltas are reduced pairwise through
:func:`repro_torch.kernels.ops.forest_merge` (the ``qo_merge`` kernel;
``sketch_merge`` under the sketch observer) in the reference's fixed
log-depth order, the merged delta folds into the forest, and the split
attempts run on the merged tables -- the same on every shard, so the
topology stays replicated without being shipped.

Two builders return the same :class:`DataParallelForest`:

* :func:`build_data_parallel_reference` runs the D shards one after the
  other in one process (one card), their deltas stacked on a leading
  (D, ...) axis;
* :func:`build_data_parallel_forest` runs one shard per rank of a
  ``torch.distributed`` group (gloo on the CPU, NCCL on GPUs); at a sync
  each rank all-gathers the (D, ...) stack and runs the same reduce and
  apply functions as the reference, so the two are bitwise equal at every
  sync boundary.

Random draws (ROADMAP C3): shard d's Poisson bagging weights come from a
``torch.Generator`` seeded from ``(seed, d)`` (:func:`shard_rng_state`),
whatever D is, so rank d and shard d draw alike.  ``update`` and
``update_window`` take injected ``bag_w`` for parity with the reference's
threefry draws.

The tree-axis ``build_sharded_forest`` and the request-sharded
``build_sharded_serving`` of the reference are not here (ROADMAP A10).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core import forest as fr
from repro_torch.core import hoeffding as ht
from repro_torch.core import stats
from repro_torch.kernels import ops as kops

__all__ = ["DataParallelForest", "init_data_parallel", "shard_rng_state",
           "build_data_parallel_reference", "build_data_parallel_forest"]


def _tmap(fn, *trees):
    """Map ``fn`` over the tensors of nested dicts of the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tmap(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def shard_rng_state(seed: int, shard: int, device) -> torch.Tensor:
    """State of shard ``shard``'s bagging generator on ``device``, seeded
    from ``(seed, shard)`` and independent of the shard count."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, shard])
                        .generate_state(1, np.uint64)[0]))
    return gen.get_state()


def _dp_init_delta(cfg: fr.ForestConfig, n_shards: int, dev):
    """Zeroed shard deltas, every tensor (n_shards, ...)-leading.

    ``ystats``: per-(tree, leaf) target Stats absorbed since the last sync
    (its ``n`` is the grace mass); ``ao_y``/``ao_sum_x``: the QO (or
    sketch) table deltas; ``err``: per-member prequential squared-error
    Stats.  All start at the merge identity (n = 0)."""
    t = cfg.tree
    D, T, M, F = n_shards, cfg.n_trees, t.max_nodes, t.n_features
    C = t.observer_bins()
    return {
        "ystats": stats.init((D, T, M), dev),
        "ao_y": stats.init((D, T, M, F, C), dev),
        "ao_sum_x": torch.zeros((D, T, M, F, C), dtype=torch.float32,
                                device=dev),
        "err": stats.init((D, T), dev),
    }


def init_data_parallel(cfg: fr.ForestConfig, seed: int, n_shards: int, *,
                       device=None):
    """Fresh data-parallel trainer state on ``device`` (default ``cuda``).

    ``forest``: a :func:`repro_torch.core.forest.init_forest` state, the
    replicated forest every shard routes against; ``delta``: the shard
    deltas (:func:`_dp_init_delta`); ``rng``: one bagging generator state
    a shard (in place of the reference's (D, T, 2) ``keys``); ``step``:
    the global batch counter that drives the sync cadence."""
    dev = dv.resolve(device)
    return {
        "forest": fr.init_forest(cfg, seed, device=dev),
        "delta": _dp_init_delta(cfg, n_shards, dev),
        "rng": [shard_rng_state(seed, d, dev) for d in range(n_shards)],
        "step": 0,
    }


def _draw_bag(cfg: fr.ForestConfig, state_rng, b: int, dev):
    """(T, b) Poisson(lambda) bagging weights from a shard's generator
    state -> (weights, the generator's next state)."""
    gen = fr._generator(state_rng, dev)
    cdf = torch.tensor(fr._poisson_cdf(cfg.lam), dtype=torch.float32,
                       device=dev)
    w = fr._poisson_weights(gen, cdf, (cfg.n_trees, b), dev)
    return w, gen.get_state()


def _dp_local_shard(cfg: fr.ForestConfig, forest, delta, X, y, w):
    """ONE shard's local step: route and absorb into its delta, no attempt.

    Routes the shard's rows through the replicated trees, accumulates the
    prequential member errors (test-then-train, unweighted raw rows) and
    the batch's leaf and table statistics into the delta.  The forest is
    read only, so every shard bins on the same grid and the deltas stay
    mergeable.  delta: this shard's (no leading axis); w: (T, b) bagging
    weights.  Returns the new delta (the QO tables are the given ones,
    updated in place)."""
    trees = forest["trees"]
    gl, leaf, batch_leaf, rows = fr._fused_route_stats(cfg, trees, X, y, w)
    yhat = torch.gather(trees["ystats"]["mean"], 1, leaf.long())
    err = stats.from_batch((yhat - y[None, :]) ** 2, dim=1)       # (T,)
    ao_y, ao_sum_x = fr._fused_absorb_tables(
        cfg, delta["ao_y"], delta["ao_sum_x"], trees, gl, X, y, w, rows)
    return {
        "ystats": stats.merge(delta["ystats"], batch_leaf),
        "ao_y": ao_y,
        "ao_sum_x": ao_sum_x,
        "err": stats.merge(delta["err"], err),
    }


def _store(stack, i: int, new) -> None:
    """Write a shard's new delta into slot i of the stacked deltas (the QO
    tables were absorbed in place there already)."""
    def put(dst, src):
        if src.data_ptr() != dst[i].data_ptr():
            dst[i].copy_(src)
    _tmap(put, stack, new)


def _table_merge(cfg: fr.ForestConfig):
    # the sketch's rank-bucket merge replaces the elementwise Chan merge
    # (slot i of two sketches covers different rank ranges)
    return kops.sketch_merge if cfg.tree.observer_backend == "sketch" \
        else kops.forest_merge


def _dp_reduce_deltas(cfg: fr.ForestConfig, delta):
    """(D, ...) stacked shard deltas -> ONE merged delta (no leading axis).

    Pairwise halving, as the reference: the first half merges with the
    second, an odd last shard is carried to the next level unmerged, so
    the order is fixed and a rerun is bitwise equal.  The (h, T, M) table
    axes of each level fold into one (h*T*M, F, C) table set: one
    ``forest_merge`` launch a level."""
    F, C = cfg.tree.n_features, cfg.tree.observer_bins()
    table_merge = _table_merge(cfg)

    def merge_pair(a, b):
        shape = a["ao_sum_x"].shape
        fold = lambda x: x.reshape((-1, F, C))
        ao_y, ao_sum_x = table_merge(
            _tmap(fold, a["ao_y"]), fold(a["ao_sum_x"]),
            _tmap(fold, b["ao_y"]), fold(b["ao_sum_x"]))
        unfold = lambda x: x.reshape(shape)
        return {
            "ystats": stats.merge(a["ystats"], b["ystats"]),
            "ao_y": _tmap(unfold, ao_y),
            "ao_sum_x": unfold(ao_sum_x),
            "err": stats.merge(a["err"], b["err"]),
        }

    while delta["ao_sum_x"].shape[0] > 1:
        k = delta["ao_sum_x"].shape[0]
        half = k // 2
        m = merge_pair(_tmap(lambda x: x[:half], delta),
                       _tmap(lambda x: x[half:2 * half], delta))
        if k % 2:
            m = _tmap(lambda x, t: torch.cat([x, t[-1:]], 0), m, delta)
        delta = m
    return _tmap(lambda x: x[0], delta)


def _dp_apply_sync(cfg: fr.ForestConfig, forest, merged):
    """Fold ONE merged delta into the forest and attempt splits.

    Leaf predictors and grace mass advance by the merged statistics, every
    table of the forest merges whole with the merged tables (also those
    whose delta is zero: no untouched-leaf shortcut), and the attempt
    stage runs on the merged tables.  The prequential error windows merge
    into ``err_win``; ``err_ewma`` is their running mean (the DP trainer
    has no drift swap).  Returns ``(forest', aux)`` with ``aux = {"mass",
    "member_mse", "n_nodes"}``."""
    T, M = cfg.n_trees, cfg.tree.max_nodes
    F, C = cfg.tree.n_features, cfg.tree.observer_bins()
    trees = forest["trees"]
    trees = dict(trees,
                 ystats=stats.merge(trees["ystats"], merged["ystats"]),
                 seen_since_attempt=trees["seen_since_attempt"]
                 + merged["ystats"]["n"])
    fold = lambda x: x.reshape((T * M, F, C))
    ao_y, ao_sum_x = _table_merge(cfg)(
        _tmap(fold, trees["ao_y"]), fold(trees["ao_sum_x"]),
        _tmap(fold, merged["ao_y"]), fold(merged["ao_sum_x"]))
    unfold = lambda x: x.reshape((T, M, F, C))
    trees = dict(trees, ao_y=_tmap(unfold, ao_y), ao_sum_x=unfold(ao_sum_x))
    trees = ht.attempt_trees(cfg.tree, trees, forest["feat_mask"])

    err_win = stats.merge(forest["err_win"], merged["err"])
    state = dict(forest, trees=trees, err_win=err_win,
                 err_ewma=torch.where(err_win["n"] > 0, err_win["mean"], 0.0))
    state["vote_w"] = fr.vote_weights(cfg, state)
    aux = {"mass": merged["ystats"]["n"].sum(),
           "member_mse": state["err_ewma"],
           "n_nodes": trees["n_nodes"]}
    return state, aux


def _stats_linear(s):
    """Stats -> summable linear encoding (n, n*mean, M2 + n*mean^2)."""
    s1 = s["n"] * s["mean"]
    return {"n": s["n"], "s1": s1, "s2": s["m2"] + s1 * s["mean"]}


def _stats_delinear(p):
    """Inverse of :func:`_stats_linear` after the sum: the
    cancellation-prone form the exact path avoids (paper §3), accepted
    here because int8 shipping is lossy by design."""
    n = p["n"]
    mean = torch.where(n > 0, p["s1"] / torch.where(n > 0, n, 1.0), 0.0)
    m2 = torch.clamp(p["s2"] - p["s1"] * mean, min=0.0)
    return {"n": n, "mean": mean, "m2": torch.where(n > 0, m2, 0.0)}


def _dp_gather_int8(delta, group):
    """This rank's delta (no leading axis) -> the merged delta through an
    int8-quantized all-reduce (DESIGN.md §4.2): every shipped plane is
    linear (Stats in the (n, n*mean, M2 + n*mean^2) encoding), quantized
    per tensor with one f32 scale, summed over the group and decoded.
    Lossy (~max|plane|/127 an element): trades the exact merge for a
    quarter of the wire bytes."""
    from repro_torch.optim import compress

    linear = {
        "ystats": _stats_linear(delta["ystats"]),
        "ao_y": _stats_linear(delta["ao_y"]),
        "ao_sum_x": delta["ao_sum_x"],
        "err": _stats_linear(delta["err"]),
    }
    summed = compress.quantized_all_reduce(linear, group)
    return {
        "ystats": _stats_delinear(summed["ystats"]),
        "ao_y": _stats_delinear(summed["ao_y"]),
        "ao_sum_x": summed["ao_sum_x"],
        "err": _stats_delinear(summed["err"]),
    }


class DataParallelForest(NamedTuple):
    """The trainer's entry points (both builders return one):

    * ``init(seed=0) -> dpstate``;
    * ``update(dpstate, X, y, *, bag_w=None) -> (dpstate, aux | None)``:
      one global batch of B rows (D must divide B; shard d takes rows
      ``d*B/D`` to ``(d+1)*B/D``), a sync when the ``sync_every`` cadence
      fires.  ``aux`` is None between syncs and ``{"mass", "member_mse",
      "n_nodes"}`` at a boundary.  ``bag_w``: optional injected (D, T,
      B/D) bagging weights;
    * ``update_window(dpstate, Xw, yw, *, bag_w=None) -> (dpstate, aux)``:
      S global batches (Xw (S, B, F), yw (S, B), bag_w (S, D, T, B/D)) of
      local steps, then an unconditional sync; bitwise equal to S
      ``update`` calls that end at a sync;
    * ``predict(dpstate, X) -> (B,)``: the vote of the replicated forest.

    The delta's QO tables are absorbed in place and zeroed in place at a
    sync: an update consumes the state it is given.
    """
    init: Any
    update: Any
    update_window: Any
    predict: Any


def _build(cfg, dev, n_shards, shards, make_state, reduce, sync_every,
           on_sync):
    """The protocol over the local ``shards`` (their deltas stacked in the
    order given); ``reduce(delta) -> merged`` is the sync's collective."""
    if sync_every < 1:
        raise ValueError(f"sync_every={sync_every}: expected >= 1")

    def local(dpstate, X, y, bag_w):
        X, y, _ = ht.as_batch(X, y, None, dev)
        B = y.shape[0]
        if B % n_shards:
            raise ValueError(f"a global batch of {B} rows does not split "
                             f"over {n_shards} shards")
        b = B // n_shards
        forest, delta = dpstate["forest"], dpstate["delta"]
        dv.check_on(forest["vote_w"], dev, "state")
        rng = list(dpstate["rng"])
        for i, d in enumerate(shards):
            if bag_w is None:
                w, rng[i] = _draw_bag(cfg, rng[i], b, dev)
            else:
                w = torch.as_tensor(bag_w[d], dtype=torch.float32,
                                    device=dev)
            rows = slice(d * b, (d + 1) * b)
            new = _dp_local_shard(cfg, forest, _tmap(lambda a: a[i], delta),
                                  X[rows], y[rows], w)
            _store(delta, i, new)
        return dict(dpstate, delta=delta, rng=rng)

    def synced(dpstate):
        forest, aux = _dp_apply_sync(cfg, dpstate["forest"],
                                     reduce(dpstate["delta"]))
        for t in _leaves(dpstate["delta"]):   # back to the merge identity
            t.zero_()
        if on_sync is not None:
            on_sync(forest, dpstate["step"], aux)    # the publish boundary
        return dict(dpstate, forest=forest), aux

    def update_fn(dpstate, X, y, *, bag_w=None):
        dpstate = local(dpstate, X, y, bag_w)
        dpstate["step"] += 1
        if dpstate["step"] % sync_every:
            return dpstate, None
        return synced(dpstate)

    def update_window_fn(dpstate, Xw, yw, *, bag_w=None):
        for s in range(len(Xw)):
            dpstate = local(dpstate, Xw[s], yw[s],
                            None if bag_w is None else bag_w[s])
        dpstate["step"] += len(Xw)
        return synced(dpstate)

    def predict_fn(dpstate, X):
        return fr.predict(cfg, dpstate["forest"], X, device=dev)

    return DataParallelForest(make_state, update_fn, update_window_fn,
                              predict_fn)


def build_data_parallel_reference(cfg: fr.ForestConfig, n_shards: int,
                                  sync_every: int = 1, on_sync=None, *,
                                  device=None) -> DataParallelForest:
    """The D-shard protocol in one process on ``device`` (default
    ``cuda``): the shards' local steps run one after the other and the
    sync reduces their stacked deltas.  This is what every rank of a
    D-process :func:`build_data_parallel_forest` computes between syncs
    and at a sync, and the distributed trainer is held bitwise against it.

    ``on_sync``: optional ``on_sync(forest_state, step, aux)``, called at
    every sync boundary with the freshly merged forest (the publish
    boundary of a serving engine)."""
    dev = dv.resolve(device)
    return _build(cfg, dev, n_shards, range(n_shards),
                  lambda seed=0: init_data_parallel(cfg, seed, n_shards,
                                                    device=dev),
                  lambda delta: _dp_reduce_deltas(cfg, delta), sync_every,
                  on_sync)


def _all_gather(t, world: int, group):
    """(1, ...) per rank -> (world, ...) on every rank."""
    import torch.distributed as dist
    out = torch.empty((world,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def build_data_parallel_forest(cfg: fr.ForestConfig, group=None,
                               sync_every: int = 1, compress=None,
                               on_sync=None, *,
                               device=None) -> DataParallelForest:
    """Data-parallel stream training over a ``torch.distributed`` group
    (default: the default group; gloo for CPU tensors, NCCL for CUDA).

    Rank d of a group of D holds the replicated forest and shard d's delta
    (a (1, ...) stack) and learns rows ``d*B/D`` to ``(d+1)*B/D`` of each
    global batch.  At a sync every rank all-gathers the (D, ...) delta
    stack and runs the reference's reduce and apply, so each rank's forest
    is bitwise equal to :func:`build_data_parallel_reference`'s at every
    sync boundary.  ``compress="int8"`` ships the deltas through an
    int8-quantized all-reduce instead (lossy, a quarter of the bytes; QO
    observer only).  ``device``: this rank's device (default: the current ``cuda`` one).
    """
    import torch.distributed as dist

    if compress not in (None, "int8"):
        raise ValueError(f"compress={compress!r}: expected None or 'int8'")
    if compress == "int8" and cfg.tree.observer_backend == "sketch":
        # Slot i of two rank-bucket sketches covers different rank ranges,
        # so their elementwise sum is no sketch of the union.
        raise ValueError("compress='int8' sums tables elementwise; the "
                         "sketch observer's tables do not add")
    dev = dv.resolve(device)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def make_state(seed=0):
        return {"forest": fr.init_forest(cfg, seed, device=dev),
                "delta": _dp_init_delta(cfg, 1, dev),
                "rng": [shard_rng_state(seed, rank, dev)],
                "step": 0}

    if compress == "int8":
        def reduce(delta):
            return _dp_gather_int8(_tmap(lambda a: a[0], delta), group)
    else:
        def reduce(delta):
            return _dp_reduce_deltas(
                cfg, _tmap(lambda a: _all_gather(a, world, group), delta))

    return _build(cfg, dev, world, [rank], make_state, reduce, sync_every,
                  on_sync)
