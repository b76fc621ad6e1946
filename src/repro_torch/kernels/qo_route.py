"""Batched routing of B rows through T trees: the kernel and its plain version.

Replaces ``src/repro/kernels/qo_route.py::qo_route_pallas``.  The tree
axis folds into global node ids (tree t's node j is ``t*M + j``) and
leaves self-loop, so one transition step is a no-op at settled rows:

    node' = x[feature[node]] <= threshold[node] ? left[node] : right[node]

with NaN going right.  :func:`forest_route_folded` launches
``csrc/qo_route.cu`` on a CUDA tensor and runs :func:`route_plain` (the
gather sweep of the reference's ``ops._forest_route_jnp``) on a CPU one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["fold_route_tables", "route_plain", "route_kernel",
           "forest_route_folded"]


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


def route_plain(feat, thr, left, right, X, T: int, M: int, plies: int):
    """Plain PyTorch sweep: (T, B) local leaf ids after ``plies`` steps."""
    B, F = X.shape
    dev = X.device
    xf = X.reshape(-1)
    cols = (torch.arange(B, device=dev) * F).repeat(T)             # (T*B,)
    offs = torch.arange(T, device=dev)[:, None] * M                # (T, 1)
    node = offs.expand(T, B).reshape(-1)
    feat, left, right = feat.long(), left.long(), right.long()
    for _ in range(plies):
        xv = xf[cols + feat[node]]
        node = torch.where(xv <= thr[node], left[node], right[node])
    return (node.reshape(T, B) - offs).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_route").qo_route_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route_kernel(feat, thr, left, right, X, T: int, M: int, plies: int):
    """Launch ``csrc/qo_route.cu``: (T, B) int32 local leaf ids."""
    B, F = X.shape
    for name, t, dt in (("feature", feat, torch.int32),
                        ("threshold", thr, torch.float32),
                        ("left", left, torch.int32),
                        ("right", right, torch.int32),
                        ("X", X, torch.float32)):
        if not t.is_cuda or t.device != X.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"qo_route: {name} must be a contiguous {dt} "
                             f"tensor on {X.device}")
    if feat.numel() != T * M:
        raise ValueError(f"qo_route: {feat.numel()} nodes, expected {T * M}")
    out = torch.empty((T, B), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _launcher()(feat.data_ptr(), thr.data_ptr(), left.data_ptr(),
                     right.data_ptr(), X.data_ptr(), out.data_ptr(),
                     T, M, B, F, plies, stream)
    _build.check(rc, "qo_route")
    _build.LAUNCHES["qo_route"] += 1
    return out


def forest_route_folded(feat, thr, left, right, X, T: int, M: int,
                        plies: int):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if X.device.type == "cpu":
        return route_plain(feat, thr, left, right, X, T, M, plies)
    return route_kernel(feat, thr, left, right, X, T, M, plies)
