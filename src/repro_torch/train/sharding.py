"""Multi-device training and serving over ``torch.distributed`` (the
reference's ``train/sharding.py``): the LM's sharding specs (DESIGN.md
§7), then the forest's data-parallel stream training, tree-axis sharded
forest and request-sharded serving (DESIGN.md §4.1 and §5).

The LM half.  Strategy: TP over the "model" mesh axis and FSDP over the
data axes ("pod", "data").  The rules are the reference's, rule by rule,
by leaf name and shape over the parameter tree of
:func:`repro_torch.models.transformer.param_shapes`; every rule falls back
to replication where a dimension does not divide its mesh axes.  A spec
is a :class:`Spec`: per tensor dimension None, one mesh-axis name or a
tuple of names (major first), printed like the reference's
``PartitionSpec`` so the two compare exactly.  :func:`to_shardings` turns
specs into ``torch.distributed.tensor`` placements on a ``DeviceMesh``
and :func:`distribute` places tensors by them.  A dimension split over
two mesh axes in an order other than the mesh's (``("model", "data")``
on a ("data", "model") mesh: the "gather" style's 2-D weights) is laid
out as JAX lays it, the first name major, through ``_StridedShard``.
Every function takes a ``DeviceMesh`` or a :class:`MeshShape` (names
and sizes alone, the reference's ``AbstractMesh``).

The forest half.

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

The tree axis: :func:`build_sharded_forest` gives each rank T/D member
trees; batches are replicated and only the forest vote's (num, den) pair
is all-reduced.  The reference keeps one threefry key a member, the port
one generator a forest, so the generator state stays replicated: every
rank draws the whole (T, B) bagging weights and (T, F) swap masks, as
the unsharded ``forest.update`` draws them, and keeps its own rows.
:func:`build_sharded_serving` splits a request's rows over the ranks,
each serving its rows from a replicated snapshot with no collective.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core import forest as fr
from repro_torch.core import hoeffding as ht
from repro_torch.core import serve as sv
from repro_torch.core import stats
from repro_torch.kernels import ops as kops

__all__ = ["Spec", "MeshShape", "mesh_axes", "mesh_sizes", "fsdp_size",
           "param_specs",
           "batch_specs", "cache_specs", "opt_specs", "placements",
           "to_shardings", "distribute", "check_mesh", "local_shard", "local",
           "DataParallelForest", "init_data_parallel", "shard_rng_state",
           "build_data_parallel_reference", "build_data_parallel_forest",
           "forest_state_specs", "ShardedForest", "build_sharded_forest",
           "build_sharded_serving"]


# --------------------------------------------------------------------------
# The LM's sharding specs (DESIGN.md §7)
# --------------------------------------------------------------------------

class Spec(tuple):
    """The reference's ``PartitionSpec``: per tensor dimension None, a
    mesh-axis name or a tuple of names (the first major).  A one-name
    tuple is stored as the name, as JAX normalises it."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        return super().__new__(cls, norm)

    def __repr__(self):
        return f"PartitionSpec({', '.join(map(repr, self))})"


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes without devices (the reference's
    ``AbstractMesh``): enough for every spec rule."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """Returns (fsdp_axes, tp_axis)."""
    tp = "model"
    return tuple(n for n in mesh.mesh_dim_names if n != tp), tp


def _div(n: int, size: int) -> bool:
    return n > 0 and n % size == 0


def fsdp_size(mesh) -> int:
    """The product of the fsdp axes' sizes."""
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in mesh_axes(mesh)[0])


def _map_paths(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(cfg, params_shapes, mesh, style: str = "contraction"):
    """Tree of :class:`Spec` matching the parameter tree (leaves with a
    ``.shape``: :func:`repro_torch.models.transformer.abstract_params`).

    style:
      "contraction" (baseline): FSDP shards the contraction (d_model) dim
        of weights;
      "gather": FSDP co-shards the weight's OUTPUT dim with TP (2-D
        sharding), so the weight shards are all-gathered (ZeRO-3).
    Any other style behaves as "contraction", as in the reference."""
    fsdp, tp = mesh_axes(mesh)
    tp_n = mesh_sizes(mesh)[tp]
    fsdp_n = fsdp_size(mesh)
    gather = style == "gather"

    def fs(dim):  # fsdp-shard a dimension if it divides
        return fsdp if _div(dim, fsdp_n) else None

    def tps(dim):
        return tp if _div(dim, tp_n) else None

    def tp_fs(dim):
        """2-D shard over (tp, fsdp...) when divisible, else best effort."""
        if _div(dim, tp_n * fsdp_n):
            return (tp,) + fsdp
        return tps(dim)

    def rule(keys, leaf):
        name = keys[-1] if keys else ""
        shp = tuple(leaf.shape)
        nd = len(shp)
        # strip the stacked-layer leading axis for rule matching
        core = shp[1:] if (keys and keys[0] in ("layers", "enc_layers")
                           and nd >= 1) else shp

        def spec(*core_spec):
            return Spec(*((None,) * (nd - len(core_spec))), *core_spec)

        if name == "embed":
            if _div(shp[0], tp_n):
                return Spec(tp, fs(shp[1]))
            return Spec(None, tps(shp[1]))
        if name == "lm_head":
            if gather:
                return Spec(None, tp_fs(shp[1]))
            return Spec(fs(shp[0]), tps(shp[1]))
        if name in ("wq", "wo"):
            # (d, H, hd) / (H, hd, d): heads over TP
            if name == "wq":
                if gather:  # output dims (H, hd) 2D-sharded -> weight gather
                    return spec(None, tps(core[1]), fs(core[2]))
                return spec(fs(core[0]), tps(core[1]), None)
            return spec(tps(core[0]), None, fs(core[2]))
        if name in ("wk", "wv"):
            if gather:
                return spec(None, tps(core[1]), fs(core[2]))
            return spec(fs(core[0]), tps(core[1]), None)
        if name in ("w_gate", "w_up", "w_down", "router"):
            if len(core) == 3:  # MoE (E, d, f) / (E, f, d)
                E = core[0]
                if gather:
                    # contraction dim never data-sharded; FSDP rides the
                    # output dim (core[2])
                    if _div(E, tp_n):  # EP: experts over tp
                        return spec(tp, None, fs(core[2]))
                    if name == "w_down":  # (E, f, d): f row-parallel
                        return spec(None, tps(core[1]), fs(core[2]))
                    return spec(None, None, tp_fs(core[2]))  # (E, d, f)
                if _div(E, tp_n):  # EP
                    return spec(tp, fs(core[1]) if name != "w_down" else None,
                                None)
                if name == "w_down":
                    return spec(None, tps(core[1]), fs(core[2]))
                return spec(None, fs(core[1]), tps(core[2]))
            if name == "router":
                return spec(fs(core[0]) if not gather else None, None)
            if name == "w_down":
                return spec(tps(core[0]), fs(core[1]))
            if gather:
                return spec(None, tp_fs(core[1]))
            return spec(fs(core[0]), tps(core[1]))
        if name in ("in_proj", "in_z", "in_x"):  # mamba1 (d, 2di); mamba2
            if gather:
                return spec(None, tp_fs(core[1]))
            return spec(fs(core[0]), tps(core[1]))
        if name in ("in_B", "in_C", "in_dt", "x_proj"):
            return spec(None if gather else fs(core[0]), None)
        if name == "dt_proj":  # (dt_rank, di)
            return spec(None, tps(core[1]))
        if name == "out_proj":  # (di, d)
            return spec(tps(core[0]), fs(core[1]))
        if name in ("A_log", "D", "dt_bias") and len(core) >= 1:
            return spec(*([tps(core[0])] + [None] * (len(core) - 1)))
        if name in ("conv_w", "conv_x"):
            return spec(None, tps(core[1]))
        if name in ("conv_B", "conv_C"):
            return spec(None, None)
        if name == "norm_scale":
            return spec(tps(core[0]))
        # norms, biases, small tables: replicate
        return Spec(*([None] * nd))

    return _map_paths(rule, params_shapes)


def batch_specs(cfg, shape_kind: str, global_batch: int, mesh):
    """``field(name) -> Spec`` for the data batches by field name."""
    fsdp, _ = mesh_axes(mesh)
    bspec = fsdp if _div(global_batch, fsdp_size(mesh)) else None

    def field(name):
        if name in ("tokens", "labels", "loss_mask"):
            return Spec(bspec, None)
        if name in ("embeds", "enc_in"):
            return Spec(bspec, None, None)
        if name == "token":     # decode: (B,) or (B, d)
            return Spec(bspec)
        raise KeyError(name)

    return field


def cache_specs(cfg, batch: int, mesh, cache_shapes):
    """Specs for the decode-cache tree (stacked layer leading axis):
    batch over the fsdp axes; k/v heads over TP when they divide, else
    the sequence over TP."""
    fsdp, tp = mesh_axes(mesh)
    tp_n = mesh_sizes(mesh)[tp]
    bspec = fsdp if _div(batch, fsdp_size(mesh)) else None

    def rule(keys, leaf):
        name = keys[-1]
        shp = tuple(leaf.shape)
        if name in ("k", "v"):
            # (L, B, S, Hkv, hd): heads over TP if divisible, else seq
            if _div(shp[3], tp_n):
                return Spec(None, bspec, None, tp, None)
            if _div(shp[2], tp_n):
                return Spec(None, bspec, tp, None, None)
            return Spec(None, bspec, None, None, None)
        if name == "pos":
            return Spec(*([None] * len(shp)))
        if name == "ssm":
            # mamba1 (L,B,di,N): di over TP; mamba2 (L,B,nh,hd,N): nh
            rest = [None] * (len(shp) - 3)
            return Spec(None, bspec, tp if _div(shp[2], tp_n) else None,
                        *rest)
        if name == "conv" or (len(keys) >= 2 and keys[-2] == "conv"):
            ch = shp[-1]
            return Spec(None, bspec, None, tp if _div(ch, tp_n) else None)
        if name in ("cross_k", "cross_v"):
            if _div(shp[3], tp_n):
                return Spec(None, bspec, None, tp, None)
            return Spec(None, bspec, None, None, None)
        return Spec(*([None] * len(shp)))

    return _map_paths(rule, cache_shapes)


def opt_specs(pspecs):
    """AdamW state shards exactly like the parameters (m, v) + a
    replicated scalar step."""
    return {"m": pspecs, "v": pspecs, "step": Spec()}


def placements(mesh, spec):
    """The ``torch.distributed.tensor`` placements (one per mesh dim) of
    a :class:`Spec` on ``mesh``.  Where a tensor dimension is split over
    several mesh axes, the spec's first name is major, as in JAX: a
    mesh dim that DTensor splits before a more major one that comes
    later on the mesh takes a ``_StridedShard`` of the later ones'
    product."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        for k, a in enumerate(axes):
            j = names.index(a)
            sf = math.prod(sizes[b] for b in axes[:k] if names.index(b) > j)
            out[j] = Shard(dim) if sf == 1 else \
                _StridedShard(dim, split_factor=sf)
    return tuple(out)


def to_shardings(mesh, spec_tree):
    """Tree of :class:`Spec` -> tree of placement tuples on ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: to_shardings(mesh, v) for k, v in spec_tree.items()}
    return placements(mesh, spec_tree)


def distribute(tree, spec_tree, mesh):
    """Place every tensor of ``tree`` on ``mesh`` by its spec: a plain
    tensor (the whole value, alike on every rank) is split by
    ``distribute_tensor`` (each rank keeps its shard, no collective); a
    DTensor already placed so is kept, one placed otherwise is
    redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, spec_tree[k], mesh) for k, v in tree.items()}
    pl = placements(mesh, spec_tree)
    if isinstance(tree, DTensor):
        if tuple(tree.placements) == pl:
            return tree
        return tree.redistribute(mesh, pl)
    return distribute_tensor(tree, mesh, pl, src_data_rank=None)


def check_mesh(mesh, dev: torch.device) -> None:
    """Raise unless ``mesh`` holds devices of ``dev``'s type (``meta``
    tensors, which hold no data, go on any mesh: the dry-run's)."""
    if dev.type != "meta" and mesh.device_type != dev.type:
        raise ValueError(f"the mesh holds {mesh.device_type} devices, "
                         f"expected {dev.type}")


def local_shard(t):
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local(t):
    """A replicated DTensor's value as a plain tensor; a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


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


def _refuse_oracle(cfg: fr.ForestConfig) -> None:
    if cfg.tree.split_backend == "oracle":
        raise ValueError("data-parallel training needs the kernel engine: "
                         "the oracle engine updates members one at a time")


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
    _refuse_oracle(cfg)
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

    _refuse_oracle(cfg)
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


# --------------------------------------------------------------------------
# Tree-axis sharded forest and request-sharded serving (DESIGN.md §5)
# --------------------------------------------------------------------------

def _member_rows(T: int, rank: int, world: int) -> slice:
    if T % world:
        raise ValueError(f"{T} trees do not split over {world} ranks")
    return slice(rank * T // world, (rank + 1) * T // world)


def forest_state_specs(state, rank: int, world: int):
    """Per leaf of a forest state, the rows of its tree axis that rank
    ``rank`` of ``world`` holds: a ``slice`` (every leaf carries the tree
    axis first), or None for the replicated generator state ``rng``."""
    rows = _member_rows(state["vote_w"].shape[0], rank, world)
    return {k: (None if k == "rng" else _tmap(lambda _: rows, v))
            for k, v in state.items()}


class ShardedForest(NamedTuple):
    """The tree-axis sharded forest's entry points:

    * ``update(state, X, y, w=None) -> (state, aux)``: one replicated
      batch; ``aux["member_mse"]`` and ``aux["drift"]`` are the rank's
      members', ``aux["forest_mse"]`` the whole forest's;
    * ``predict(state, X) -> (B,)``: the whole forest's vote;
    * ``shard(state) -> state``: the rank's members of a whole forest
      state (a copy; ``rng`` replicated).
    """
    update: Any
    predict: Any
    shard: Any


def build_sharded_forest(cfg: fr.ForestConfig, group=None, *,
                         device=None) -> ShardedForest:
    """The forest with its T trees split over the ranks of a
    ``torch.distributed`` group (default: the default group), T/D each.

    Every rank learns the whole (replicated) batch into its members; the
    forest vote's (num, den) pair is all-reduced over the group, the only
    collective.  The rank draws the whole forest's bagging weights and
    swap masks from the replicated generator and keeps its rows, so the
    sharded forest equals the unsharded ``forest.update`` while no drift
    swap fires (bitwise on one rank).  The drift swap is resolved among a
    rank's members, so under simultaneous drift D ranks may reset up to D
    members a batch where the unsharded forest resets one.  ``device``:
    this rank's device (default: the current ``cuda`` one)."""
    import torch.distributed as dist

    dev = dv.resolve(device)
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    T, F = cfg.n_trees, cfg.tree.n_features
    mine = _member_rows(T, rank, world)

    def shard(state):
        specs = forest_state_specs(state, rank, world)
        return _tmap(lambda a, rows: a.clone() if rows is None
                     else a[rows].clone(), state, specs)

    def update_fn(state, X, y, w=None):
        B = ht.as_batch(X, y, w, dev)[1].shape[0]
        gen = fr._generator(state["rng"], dev)
        cdf = torch.tensor(fr._poisson_cdf(cfg.lam), dtype=torch.float32,
                           device=dev)
        bag_w = fr._poisson_weights(gen, cdf, (T, B), dev)
        masks = fr._draw_masks(gen, T, F, cfg.subspace_k(), dev)
        state, aux = fr.update(cfg, state, X, y, w, bag_w=bag_w[mine],
                               new_masks=masks[mine], device=dev,
                               group=group)
        return dict(state, rng=gen.get_state()), aux

    def predict_fn(state, X):
        return fr.predict(cfg, state, X, device=dev, group=group)

    return ShardedForest(update_fn, predict_fn, shard)


def build_sharded_serving(snap, group=None, *, device=None):
    """``predict_fn(snap, X) -> (B/D,)``: the rank's rows of a request.

    The read-side complement of :func:`build_sharded_forest`: every rank
    holds the whole (replicated) snapshot and serves rows ``r*B/D`` to
    ``(r+1)*B/D`` of X (D must divide B), with no collective.  The ply
    budget is set at build from ``snap``'s depth (rounded up to even, as
    the reference buckets it), so a refreshed snapshot that grew deeper,
    or one of another ``single``, is refused with a ``ValueError``:
    rebuild then."""
    import torch.distributed as dist

    dev = dv.resolve(device)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    plies = 2 * math.ceil(snap.depth / 2)
    single = snap.single

    def predict_fn(s, X):
        if s.single != single or s.depth > plies:
            raise ValueError(
                f"snapshot (single={s.single}, depth={s.depth}) does not "
                f"fit this serving build (single={single}, ply budget "
                f"{plies}): rebuild build_sharded_serving")
        dv.check_on(s.feature, dev, "snapshot")
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        B = X.shape[0]
        if B % world:
            raise ValueError(f"a request of {B} rows does not split over "
                             f"{world} ranks")
        return sv.predict_snapshot(
            s, X[rank * B // world:(rank + 1) * B // world], device=dev)

    return predict_fn
