"""Frozen serving snapshots (the reference's ``core/serve.py``, §5.5).

:func:`freeze` packs a trained tree or forest into a :class:`Snapshot`:
nodes renumbered breadth first (a host-side numpy walk, ported nearly
verbatim), capacity trimmed to the realized node count (a power of two,
at least 8), the stored ``depth`` the deepest realized leaf, leaf means
and vote weights gathered in, QO tables dropped.  The arrays are the
reference's, value for value.

:func:`predict_snapshot` serves it through the same routing kernel and
the same vote reduce as the live :func:`repro_torch.core.forest.predict`,
so its predictions equal the live state's bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core.forest import vote_combine
from repro_torch.kernels import ops as kops

__all__ = ["Snapshot", "SnapshotValidationError", "freeze",
           "validate_snapshot", "predict_snapshot"]


@dataclass(frozen=True)
class Snapshot:
    """Dense breadth-first serving layout.

    (T, Mr) tree axis even for a single tree (T = 1, ``single=True``):
    ``feature`` i32, ``threshold`` f32, ``child`` (T, Mr, 2) i32 (-1 at
    leaves), ``is_leaf`` bool, ``leaf_mean`` f32, ``vote_w`` (T,) f32;
    ``depth`` the realized ply count; ``version`` / ``step`` the
    publisher's stamps."""
    feature: torch.Tensor
    threshold: torch.Tensor
    child: torch.Tensor
    is_leaf: torch.Tensor
    leaf_mean: torch.Tensor
    vote_w: torch.Tensor
    depth: int
    single: bool
    version: int = 0
    step: int = 0


class SnapshotValidationError(ValueError):
    """A Snapshot violates the serving invariants (torn/corrupt model)."""


def validate_snapshot(snap: Snapshot) -> Snapshot:
    """Check the serving invariants on the host; raise
    :class:`SnapshotValidationError`.  Per tree: finite thresholds and
    non-negative features on internal nodes; children in ``[0, Mr)``,
    each greater than its parent and claimed once, the root never a
    child; ``-1`` children at leaves; finite leaf means; finite,
    non-negative vote weights; non-negative stamps."""
    feat = snap.feature.cpu().numpy()
    thr = snap.threshold.cpu().numpy()
    child = snap.child.cpu().numpy()
    is_leaf = snap.is_leaf.cpu().numpy()
    mean = snap.leaf_mean.cpu().numpy()
    vote_w = snap.vote_w.cpu().numpy()
    T, Mr = feat.shape

    def bad(msg):
        raise SnapshotValidationError(
            f"snapshot v{snap.version} (step {snap.step}): {msg}")

    if not (np.isfinite(vote_w).all() and (vote_w >= 0).all()):
        bad("vote weights must be finite and non-negative")
    if not np.isfinite(mean).all():
        bad("leaf means must be finite")
    if snap.version < 0 or snap.step < 0:
        bad("version/step stamps must be non-negative")
    for t in range(T):
        internal = ~is_leaf[t]
        if not np.isfinite(thr[t][internal]).all():
            bad(f"tree {t}: non-finite threshold on an internal node")
        if internal.any() and (feat[t][internal] < 0).any():
            bad(f"tree {t}: negative feature id on an internal node")
        ch = child[t][internal]
        if (child[t][~internal] != -1).any():
            bad(f"tree {t}: leaf rows must carry -1 children")
        if internal.any():
            if ch.min() < 0 or ch.max() >= Mr:
                bad(f"tree {t}: child id out of range [0, {Mr})")
            parents = np.nonzero(internal)[0]
            if (ch <= parents[:, None]).any():
                bad(f"tree {t}: child id <= parent id breaks the BFS "
                    f"level-order contract")
            flat = ch.reshape(-1)
            if len(np.unique(flat)) != len(flat) or (flat == 0).any():
                bad(f"tree {t}: a node is claimed by two parents (or the "
                    f"root is a child)")
    return snap


def _bfs_reindex(feature, threshold, child, is_leaf, mean, Mr: int):
    """One tree's numpy arrays -> breadth-first arrays of capacity Mr,
    plus the realized depth."""
    order, node_depth = [0], [0]
    new_id = {0: 0}
    head = 0
    while head < len(order):
        u = order[head]
        head += 1
        if not is_leaf[u]:
            for c in child[u]:
                new_id[int(c)] = len(order)
                order.append(int(c))
                node_depth.append(node_depth[new_id[u]] + 1)
    n = len(order)
    assert n <= Mr, (n, Mr)
    f = np.zeros(Mr, np.int32)
    thr = np.zeros(Mr, np.float32)
    ch = np.full((Mr, 2), -1, np.int32)
    lf = np.ones(Mr, bool)
    mu = np.zeros(Mr, np.float32)
    for i, u in enumerate(order):
        f[i], thr[i], lf[i] = feature[u], threshold[u], is_leaf[u]
        mu[i] = mean[u] if is_leaf[u] else 0.0
        if not is_leaf[u]:
            ch[i] = [new_id[int(child[u][0])], new_id[int(child[u][1])]]
    return f, thr, ch, lf, mu, (max(node_depth) if n else 0)


def freeze(state, *, version: int = 0, step: int = 0,
           device=None) -> Snapshot:
    """Pack a tree state (:func:`repro_torch.core.hoeffding.init_state`) or
    a forest state (detected by its ``"trees"`` key) into a validated
    Snapshot on ``device`` (default ``cuda``)."""
    dev = dv.resolve(device)
    if "trees" in state:
        trees, single = state["trees"], False
        vote_w = state["vote_w"].detach().cpu().numpy()
    else:
        trees = {k: ({kk: vv[None] for kk, vv in v.items()}
                     if isinstance(v, dict) else v[None])
                 for k, v in state.items()}
        vote_w, single = np.ones((1,), np.float32), True
    host = lambda a: a.detach().cpu().numpy()
    feat, thr = host(trees["feature"]), host(trees["threshold"])
    child, is_leaf = host(trees["child"]), host(trees["is_leaf"])
    mean, n_nodes = host(trees["ystats"]["mean"]), host(trees["n_nodes"])
    T = feat.shape[0]

    Mr = 8
    while Mr < int(n_nodes.max()):
        Mr *= 2
    packed = [_bfs_reindex(feat[t], thr[t], child[t], is_leaf[t], mean[t], Mr)
              for t in range(T)]
    stack = lambda i: torch.as_tensor(np.stack([p[i] for p in packed]),
                                      device=dev)
    return validate_snapshot(Snapshot(
        feature=stack(0), threshold=stack(1), child=stack(2),
        is_leaf=stack(3), leaf_mean=stack(4),
        vote_w=torch.as_tensor(vote_w, dtype=torch.float32, device=dev),
        depth=max(p[5] for p in packed), single=single,
        version=int(version), step=int(step)))


def predict_snapshot(snap: Snapshot, X, *, device=None) -> torch.Tensor:
    """Serve a frozen snapshot: X (B, F) -> (B,) f32 predictions, equal bit
    for bit to the live ``predict`` of the state that was frozen."""
    dev = dv.resolve(device)
    dv.check_on(snap.feature, dev, "snapshot")
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    leaf = kops.forest_route(snap.feature, snap.threshold, snap.child,
                             snap.is_leaf, X, depth=snap.depth)
    member = torch.gather(snap.leaf_mean, 1, leaf.long())          # (T, B)
    if snap.single:
        return member[0]
    return vote_combine(member, snap.vote_w)
