"""The system under test: the PyTorch/CUDA port ``repro_torch``, reached
only through its public entry points (``core.forest``, ``core.serve``
and the route of ``kernels.ops``).  The checkout's ``src/`` must be on
``sys.path``."""
from __future__ import annotations

import torch


def forest_config(cfg):
    """The port's ``ForestConfig`` for a configuration file's settings."""
    from repro_torch.core import forest, hoeffding
    if not cfg["drift_swap"]:
        raise ValueError("the port always swaps a drifting member")
    tree = hoeffding.HTRConfig(
        n_features=cfg["n_features"], max_nodes=cfg["max_nodes"],
        n_bins=cfg["n_bins"], grace_period=cfg["grace_period"],
        delta=cfg["delta"], tau=cfg["tau"], max_depth=cfg["max_depth"],
        r0=cfg["r0"], sigma_k=cfg["sigma_k"], split_backend="auto",
        attempt_schedule=cfg["attempt_schedule"], compact_query=True,
        decision_backend=cfg["decision"], observer_backend=cfg["observer"],
        sketch_k=cfg["sketch_k"])
    return forest.ForestConfig(
        tree=tree, n_trees=cfg["n_trees"], lam=float(cfg["lam"]),
        subspace=cfg["subspace"], vote=cfg["vote"], vote_power=cfg["vote_power"],
        drift_alpha=cfg["drift_alpha"], drift_decay=cfg["drift_decay"],
        drift_kappa=cfg["drift_kappa"], drift_min_batches=cfg["drift_min_batches"])


def init(fcfg, seed, mask0, device):
    from repro_torch.core import forest
    return forest.init_forest(fcfg, int(seed) % (2 ** 63), device=device, feat_mask=mask0)


def update(fcfg, state, X, y, bag_w, new_masks, device):
    """One prequential step (predict, then learn), the draws injected."""
    from repro_torch.core import forest
    return forest.update(fcfg, state, X, y, bag_w=bag_w, new_masks=new_masks,
                         device=device)


def route(state, X, depth):
    """(T, B) leaf ids of the forest's route at ``state``."""
    from repro_torch.kernels import ops
    t = state["trees"]
    return ops.forest_route(t["feature"], t["threshold"], t["child"], t["is_leaf"],
                            X, depth=depth)


def freeze(state, device):
    from repro_torch.core import serve
    return serve.freeze(state, device=device)


def predict_snapshot(snap, X, device):
    from repro_torch.core import serve
    return serve.predict_snapshot(snap, X, device=device)


def clone(state):
    """A deep copy of a state (the port updates its tables in place)."""
    if isinstance(state, dict):
        return {k: clone(v) for k, v in state.items()}
    return state.clone() if isinstance(state, torch.Tensor) else state
