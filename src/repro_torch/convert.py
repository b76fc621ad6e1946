"""Carry tree states, forest states and snapshots across from the JAX
package (as numpy arrays) and back.

Key names, shapes and dtypes are the same on both sides.  One leaf does
not carry over: the reference's threefry ``keys`` (ROADMAP C3).  It is
dropped on the way in and replaced by ``rng``, the state of a
``torch.Generator`` seeded with ``seed``; on the way out ``rng`` is left
behind.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core.serve import Snapshot, validate_snapshot

__all__ = ["state_from_numpy", "state_to_numpy", "snapshot_from_numpy",
           "snapshot_to_numpy"]

_SNAPSHOT_ARRAYS = ("feature", "threshold", "child", "is_leaf", "leaf_mean",
                    "vote_w")


def _to_torch(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=dev)


def state_from_numpy(tree, device=None, *, seed: int = 0):
    """Nested dict of numpy arrays (a tree or forest state) -> tensors on
    ``device`` (default ``cuda``).  A forest's ``keys`` becomes ``rng``."""
    dev = dv.resolve(device)
    out = _to_torch({k: v for k, v in tree.items() if k != "keys"}, dev)
    if "keys" in tree:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        out["rng"] = gen.get_state()
    return out


def state_to_numpy(state):
    """Tensors -> nested dict of numpy arrays (``rng`` left behind)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items() if k != "rng"}
    return state.detach().cpu().numpy()


def snapshot_from_numpy(arrays, *, depth: int, single: bool,
                        version: int = 0, step: int = 0,
                        device=None) -> Snapshot:
    """The six snapshot arrays (a dict of numpy arrays) + static fields ->
    a validated :class:`Snapshot` on ``device`` (default ``cuda``)."""
    dev = dv.resolve(device)
    return validate_snapshot(Snapshot(
        **{k: torch.as_tensor(np.array(arrays[k]), device=dev)
           for k in _SNAPSHOT_ARRAYS},
        depth=int(depth), single=bool(single), version=int(version),
        step=int(step)))


def snapshot_to_numpy(snap: Snapshot) -> dict:
    """The six snapshot arrays as numpy."""
    return {k: getattr(snap, k).detach().cpu().numpy()
            for k in _SNAPSHOT_ARRAYS}
