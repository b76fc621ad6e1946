"""Carry tree states, forest states, data-parallel trainer states,
snapshots, and LM parameters and AdamW states across from the JAX package
(as numpy arrays) and back.

Key names, shapes and dtypes are the same on both sides.  One leaf does
not carry over: the reference's threefry ``keys`` (ROADMAP C3).  It is
dropped on the way in and replaced by ``rng``, the state of a
``torch.Generator`` seeded with ``seed`` (for a data-parallel state, one
generator state a shard); on the way out ``rng`` is left behind.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core.serve import Snapshot, validate_snapshot
from repro_torch.models.transformer import LM, tree_of
from repro_torch.train.sharding import shard_rng_state

__all__ = ["state_from_numpy", "state_to_numpy", "dp_state_from_numpy",
           "dp_state_to_numpy", "snapshot_from_numpy", "snapshot_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy",
           "lm_opt_state_from_numpy", "lm_opt_state_to_numpy"]

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


def dp_state_from_numpy(dp, device=None, *, seed: int = 0):
    """A reference data-parallel state ``{forest, delta, keys, step}`` (numpy
    arrays) -> the port's ``{forest, delta, rng, step}`` on ``device``
    (default ``cuda``).  ``forest`` and ``delta`` go tensor for tensor;
    the (D, T, 2) ``keys`` become D shard generator states seeded from
    ``seed``, as :func:`repro_torch.train.sharding.init_data_parallel`
    seeds them."""
    dev = dv.resolve(device)
    return {"forest": state_from_numpy(dp["forest"], dev, seed=seed),
            "delta": _to_torch(dp["delta"], dev),
            "rng": [shard_rng_state(seed, d, dev)
                    for d in range(np.shape(dp["keys"])[0])],
            "step": int(dp["step"])}


def dp_state_to_numpy(dp):
    """The port's data-parallel state -> ``{forest, delta, step}`` as numpy
    (the generator states left behind)."""
    return {"forest": state_to_numpy(dp["forest"]),
            "delta": state_to_numpy(dp["delta"]), "step": int(dp["step"])}


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


def lm_params_from_numpy(cfg, tree, device=None):
    """The reference's LM parameter pytree (nested dicts of numpy arrays,
    ``models/model.py::init_params``'s layout) -> an
    :class:`repro_torch.models.transformer.LM` on ``device`` (default
    ``cuda``)."""
    return LM(cfg, _to_torch(tree, dv.resolve(device)))


def lm_params_to_numpy(params):
    """An :class:`~repro_torch.models.transformer.LM` (or its ``tree()``)
    -> the reference's nested dict of numpy arrays."""
    return state_to_numpy(tree_of(params))


def lm_opt_state_from_numpy(opt, device=None):
    """The reference's AdamW state ``{m, v, step}`` (numpy) -> tensors on
    ``device`` (default ``cuda``); ``step`` a 0-d int32 tensor."""
    return _to_torch(opt, dv.resolve(device))


def lm_opt_state_to_numpy(opt):
    """The port's AdamW state -> ``{m, v, step}`` as numpy."""
    return state_to_numpy(opt)
