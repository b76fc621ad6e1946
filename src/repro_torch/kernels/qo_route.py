"""Batched routing of B rows through T trees: the kernel and its plain version.

Replaces ``src/repro/kernels/qo_route.py::qo_route_pallas``.  Both take the
tree arrays as the state holds them -- ``feature``, ``threshold``,
``is_leaf`` (T, M) and ``child`` (T, M, 2) with -1 at leaves -- and give
the (T, B) int32 local leaf ids after at most ``plies`` steps of

    node' = x[feature[node]] <= threshold[node] ? left[node] : right[node]

with NaN going right and a leaf a self-loop, so any ``plies`` at least the
deepest leaf's depth gives the same ids.  :func:`forest_route` launches
``csrc/qo_route.cu`` (one launch, nothing else on the device) on a CUDA
tensor and runs :func:`route_plain` (the reference's gather sweep
``ops._forest_route_jnp`` over tables folded by :func:`fold_route_tables`)
on a CPU one.  ``rows`` (rows a block, one thread a row) is the launch's
schedule knob: :data:`ROWS_CHOICES` are compiled, every one gives the
same ids, and the plain version never sees it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["fold_route_tables", "route_plain", "route_kernel",
           "forest_route", "cost", "ROWS", "ROWS_CHOICES"]

#: Rows a block by default, and the values ``csrc/qo_route.cu`` is
#: compiled for (one template instantiation each).
ROWS = 256
ROWS_CHOICES = (128, 256, 512)


def cost(T: int, M: int, B: int, F: int, plies: int, nodes=None,
         walked=None):
    """``(bytes, flops)`` a route must at least move and do: every
    allocated node's 17 bytes (``nodes``; all T*M unless given), X and the
    ids once; a compare and a select for each ply walked (``walked``; the
    most, T*B*plies, unless given)."""
    nodes = T * M if nodes is None else nodes
    walked = T * B * plies if walked is None else walked
    return nodes * 17 + B * F * 4 + T * B * 4, walked * 2


def fold_route_tables(feature, threshold, child, is_leaf):
    """(T, M) node arrays -> folded self-looped (T*M,) transition tables.

    Returns ``(feature, threshold, left, right)``: int32, f32, int32,
    int32.  Leaves get ``left = right = self`` and feature 0 (never read
    for a decision, but always a legal column)."""
    T, M = feature.shape
    N = T * M
    dev = feature.device
    offs = torch.arange(T, dtype=torch.int32, device=dev)[:, None] * M
    gids = offs + torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    gchild = torch.where(child >= 0, child + offs[..., None], -1)
    left = torch.where(is_leaf, gids, gchild[..., 0]).reshape(N)
    right = torch.where(is_leaf, gids, gchild[..., 1]).reshape(N)
    feat = torch.where(is_leaf, 0, feature).reshape(N)
    return (feat.to(torch.int32).contiguous(),
            threshold.reshape(N).to(torch.float32).contiguous(),
            left.to(torch.int32).contiguous(),
            right.to(torch.int32).contiguous())


def route_plain(feature, threshold, child, is_leaf, X, plies: int):
    """Plain PyTorch sweep over the folded tables: (T, B) local leaf ids.
    Stops early once every row sits at a leaf (one host read a ply)."""
    T, M = feature.shape
    B, F = X.shape
    feat, thr, left, right = fold_route_tables(feature, threshold, child,
                                               is_leaf)
    leaf = is_leaf.reshape(-1)
    dev = X.device
    xf = X.reshape(-1)
    cols = (torch.arange(B, device=dev) * F).repeat(T)             # (T*B,)
    offs = torch.arange(T, device=dev)[:, None] * M                # (T, 1)
    node = offs.expand(T, B).reshape(-1)
    feat, left, right = feat.long(), left.long(), right.long()
    for _ in range(plies):
        if bool(leaf[node].all()):
            break
        xv = xf[cols + feat[node]]
        node = torch.where(xv <= thr[node], left[node], right[node])
    return (node.reshape(T, B) - offs).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_route").qo_route_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route_kernel(feature, threshold, child, is_leaf, X, plies: int,
                 rows: int = ROWS):
    """Launch ``csrc/qo_route.cu`` with ``rows`` rows a block: (T, B)
    int32 local leaf ids."""
    rows = _build.check_knob("qo_route", "rows", rows, ROWS_CHOICES)
    T, M = feature.shape
    B, F = X.shape
    for name, t, dt, shape in (("feature", feature, torch.int32, (T, M)),
                               ("threshold", threshold, torch.float32,
                                (T, M)),
                               ("child", child, torch.int32, (T, M, 2)),
                               ("is_leaf", is_leaf, torch.bool, (T, M)),
                               ("X", X, torch.float32, (B, F))):
        if not t.is_cuda or t.device != X.device or t.dtype != dt \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"qo_route: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {X.device}")
    out = torch.empty((T, B), dtype=torch.int32, device=X.device)
    if T * B == 0:
        return out
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _launcher()(feature.data_ptr(), threshold.data_ptr(),
                     child.data_ptr(), is_leaf.data_ptr(), X.data_ptr(),
                     out.data_ptr(), T, M, B, F, plies, rows, stream)
    _build.check(rc, "qo_route")
    # the allocated nodes: every root, and two children a split
    _build.launched("qo_route", lambda: cost(
        T, M, B, F, plies, nodes=T + 2 * int((child[..., 0] >= 0).sum())))
    return out


def forest_route(feature, threshold, child, is_leaf, X, plies: int,
                 rows: int = ROWS):
    """The plain version on a CPU tensor, else the kernel (or a raise).
    ``rows`` is checked on both: the plain version never sees it."""
    if X.device.type == "cpu":
        _build.check_knob("qo_route", "rows", rows, ROWS_CHOICES)
        return route_plain(feature, threshold, child, is_leaf, X, plies)
    return route_kernel(feature, threshold, child, is_leaf, X, plies, rows)
