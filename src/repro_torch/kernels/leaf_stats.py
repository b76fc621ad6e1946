"""A routed batch's per-leaf target statistics, merged into the running ones.

Replaces no TPU kernel: the JAX package leaves this step to XLA
(``csrc/leaf_stats.cu`` says why the port has a kernel for it).  For each
entry e of the folded (T*M,) leaf axis, over the rows the batch routed
there (row r of the folded batch is batch row ``r % B`` of tree ``r // B``,
weighted ``w[r]``):

1. the batch's weighted (n, mean, M2), M2 by the two-pass residual
   (``hoeffding.segment_stats``);
2. a Chan merge of those into the running ``ystats`` (``stats.merge``, on
   every entry, a leaf the batch missed included) and n added to
   ``seen_since_attempt``.

:func:`leaf_stats` runs :func:`leaf_stats_plain` (that composition, which
returns new tensors) on a CPU tensor and launches the kernel on a CUDA one
(in place on the four arrays, which it returns).  The rows come sorted by
leaf: ``rows=(order, offsets)`` from ``qo_update_leaves.sort_rows``, the
sort the absorb walks.  Both versions write ``bad`` (a (1,) bool tensor):
True when some id lies outside [0, T*M), so that the runs cover fewer rows
than there are.  The kernel makes no host read of its own, so its caller
reads ``bad`` with a read it makes anyway and raises
:func:`out_of_range` (the plain version's segment sums refuse such ids
first).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import hoeffding as ht
from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["leaf_stats", "leaf_stats_plain", "leaf_stats_kernel",
           "out_of_range", "cost"]


def cost(N: int, R: int, B: int):
    """``(bytes, flops)`` of one call over N entries and R folded rows of a
    B-row batch: the offsets, the order, the weights and y read once, the
    three statistics and the seen count read and written once; about 7
    flops a row (two passes) and 20 an entry (the merge)."""
    return (N + 1) * 4 + R * 8 + B * 4 + N * 32 + 1, R * 7 + N * 20


def leaf_stats_plain(ystats, seen, gl, y, w, rows, bad):
    """``segment_stats``, ``stats.merge`` and the seen add, as the forest
    step composed them: returns new ``(ystats, seen)``; writes ``bad``."""
    N, B = seen.shape[0], y.shape[0]
    offsets = rows[1]
    bad.copy_((offsets[-1] - offsets[0] != gl.shape[0]).reshape(1))
    batch = ht.segment_stats(y.repeat(gl.shape[0] // max(B, 1)), gl, N, w,
                             rows)
    return stats.merge(ystats, batch), seen + batch["n"]


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("leaf_stats")
    lib.leaf_stats_launch.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.leaf_stats_launch.restype = ctypes.c_int
    return lib


def leaf_stats_kernel(ystats, seen, y, w, rows, bad):
    """Launch ``csrc/leaf_stats.cu``: in place on ``ystats`` and ``seen``
    (each (N,) float32), writes ``bad``; returns ``(ystats, seen)``."""
    order, offsets = rows
    N, B, n_rows = seen.shape[0], y.shape[0], order.shape[0]
    dev = y.device
    for name, t, shape in (("n", ystats["n"], (N,)),
                           ("mean", ystats["mean"], (N,)),
                           ("m2", ystats["m2"], (N,)), ("seen", seen, (N,)),
                           ("y", y, (B,)), ("w", w, (n_rows,))):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"leaf_stats: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}")
    for name, t, shape in (("order", order, (n_rows,)),
                           ("offsets", offsets, (N + 1,))):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"leaf_stats: {name} must be a contiguous "
                             f"int32 {shape} tensor on {dev}")
    if bad.device != dev or bad.dtype != torch.bool or bad.numel() != 1:
        raise ValueError(f"leaf_stats: bad must be a (1,) bool on {dev}")
    if n_rows % max(B, 1) or n_rows >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError(f"leaf_stats: {n_rows} rows are not whole batches "
                         f"of {B}, or a call outgrows int32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().leaf_stats_launch(
        order.data_ptr(), offsets.data_ptr(), y.data_ptr(), w.data_ptr(),
        ystats["n"].data_ptr(), ystats["mean"].data_ptr(),
        ystats["m2"].data_ptr(), seen.data_ptr(), bad.data_ptr(), N, n_rows,
        B, stream)
    _build.check(rc, "leaf_stats")
    _build.launched("leaf_stats", lambda: cost(N, n_rows, B))
    return ystats, seen


def leaf_stats(ystats, seen, gl, y, w, rows, bad):
    """The plain version on a CPU tensor (new tensors), else the kernel (in
    place; ``gl`` unused) or a raise.  Returns ``(ystats, seen)``."""
    if y.device.type == "cpu":
        return leaf_stats_plain(ystats, seen, gl, y, w, rows, bad)
    return leaf_stats_kernel(ystats, seen, y, w, rows, bad)


def out_of_range(gl, n: int) -> RuntimeError:
    """The error of a batch whose folded leaf ids leave [0, n), naming the
    first few such ids (a host read, on the failing step only)."""
    ids = torch.unique(gl[(gl < 0) | (gl >= n)])[:8].tolist()
    return RuntimeError(f"leaf_stats: leaf ids outside [0, {n}): {ids}")
