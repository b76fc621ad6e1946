"""E-BST and Truncated E-BST baselines (paper §1/§5; the reference's
``core/ebst.py``).

Ikonomovska et al.'s Extended Binary Search Tree: every node stores a key
and the target statistics of every observation with ``x <= key`` that
passed through it; an insert walks the tree (O(depth)) and the split query
is an in-order traversal accumulating the left context.  TE-BST rounds x
to ``decimals`` places first, which bounds the number of distinct keys.

Nodes live in fixed-capacity arrays (the reference's dict layout and
names, :func:`init`); at capacity further rows only update the statistics
along their path.  :func:`update` and :func:`best_split` run one kernel
call each of ``csrc/ebst.cu`` on the card (:mod:`repro_torch.kernels.ebst`),
the plain versions on the CPU.  Trees are returned new, never updated in
place.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as dv
from repro_torch.core import stats
from repro_torch.kernels import ebst as kebst
from repro_torch.kernels.qo_query import SplitResult

EBST = Dict[str, object]

__all__ = ["init", "update", "best_split", "n_elements"]


def init(capacity: int, decimals: int = -1, *, device=None) -> EBST:
    """Empty E-BST of ``capacity`` nodes on ``device`` (default ``cuda``).
    ``decimals >= 0`` makes it a TE-BST.  At capacity 10^6 the arrays take
    24 MB (and a query's scratch 64 MB more)."""
    dev = dv.resolve(device)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "key": torch.zeros((capacity,), dtype=torch.float32, device=dev),
        "left": torch.full((capacity,), -1, **i32),
        "right": torch.full((capacity,), -1, **i32),
        "le": stats.init((capacity,), dev),
        "size": torch.zeros((), **i32),
        "total": stats.init((), dev),
        "decimals": torch.tensor(decimals, **i32),
    }


def _clone(t: EBST) -> EBST:
    return {k: ({kk: vv.clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in t.items()}


def update(t: EBST, xs, ys, *, device=None) -> EBST:
    """Insert a batch in order (streams are sequential by definition) ->
    a new tree.  xs, ys: any shapes, flattened."""
    dev = dv.resolve(device)
    dv.check_on(t["key"], dev, "tree")
    as32 = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                     device=dev).reshape(-1).contiguous()
    out = _clone(t)
    kebst.insert(out, as32(xs), as32(ys))
    return out


def n_elements(t: EBST) -> torch.Tensor:
    """Nodes stored, () i32 (the paper's memory metric)."""
    return t["size"]


def best_split(t: EBST, *, device=None) -> SplitResult:
    """The exact best split over every stored key: ``threshold`` (x <=
    threshold goes left), ``merit`` (VR; 0 when not valid), ``valid``."""
    dv.check_on(t["key"], dv.resolve(device), "tree")
    thr, merit, valid = kebst.query(t)
    return SplitResult(threshold=thr, merit=merit, valid=valid)
