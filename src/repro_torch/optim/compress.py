"""Gradient compression (the reference's ``optim/compress.py``,
DESIGN.md §4.2), over nested dicts of tensors.

1. **QO-thresholded top-k sparsification with error feedback**
   (:func:`sparsify_with_sketch`).  The k-th magnitude of a large gradient
   normally costs a sort or a top-k; here |g| is fed into a QO table
   (O(1) a value, O(bins) memory: the ``qo_update`` kernel on the card)
   and the (1 - keep_frac) quantile is read off it.  The residual is kept
   locally and added back next step (error feedback).
2. **int8 quantized all-reduce** (:func:`quantized_all_reduce`): per-leaf
   symmetric int8 quantization before the sum, dequantization after.  The
   wire carries int8-range integers (summed as int32) and one f32 scale a
   leaf; the data-parallel trainer ships its sync deltas through it with
   ``compress="int8"``.
"""
from __future__ import annotations

import torch

from repro_torch.core import qo as qo_lib
from repro_torch.core import sketch

__all__ = ["init_error_state", "sketch_threshold", "sparsify_with_sketch", "int8_encode",
           "int8_decode", "quantized_all_reduce"]


def _map(fn, *trees):
    """``fn`` over the leaves of same-structure nested dicts of tensors, in
    the dicts' order (every rank walks a collective's leaves alike)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_error_state(params):
    """Zero error-feedback state shaped like ``params``."""
    return _map(torch.zeros_like, params)


def sketch_threshold(g, keep_frac=0.05, bins=256):
    """0-d: the (1 - keep_frac) quantile of |g| read off a QO table of
    ``bins`` bins at radius sigma/2 (population std) and origin mean(|g|)
    (the paper's dynamic radius r = sigma / k)."""
    flat = g.abs().reshape(-1)
    sig = torch.clamp(torch.std(flat, correction=0), min=1e-12)
    table = qo_lib.init(bins, radius=1.0, origin=0.0, device=g.device)
    table = dict(table, radius=sig / 2.0, origin=torch.mean(flat))
    table = qo_lib.update(table, flat, flat, device=g.device)
    return sketch.quantile(table, 1.0 - keep_frac)


def sparsify_with_sketch(grads, error, keep_frac=0.05, bins=256):
    """Top-``keep_frac`` sparsification of every leaf through a QO-table
    quantile of |g + e|.  Returns ``(sparse, new_error, {"density": ()})``
    with ``g + e == sparse + new_error`` leaf for leaf; density is the mean
    over leaves of the kept fraction."""
    density = []

    def one(g, e):
        g = g + e                   # error feedback: compress the sum
        mask = g.abs() >= sketch_threshold(g, keep_frac, bins)
        sparse = torch.where(mask, g, 0.0)
        density.append(mask.to(torch.float32).mean())
        return sparse, g - sparse

    pairs = _map(one, grads, error)
    return (_map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs),
            {"density": torch.stack(density).mean()})


def _scale(g):
    return torch.clamp(g.abs().max(), min=1e-12) / 127.0


def _quantize(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def int8_encode(g):
    """f32 tensor -> (int8 tensor, f32 scale): symmetric, max |g| -> 127."""
    scale = _scale(g)
    return _quantize(g, scale), scale


def int8_decode(q, scale):
    return q.to(torch.float32) * scale


def quantized_all_reduce(tree, group=None):
    """int8 all-reduce of every tensor of a nested dict over ``group``
    (the reference's ``quantized_psum``): the scale must agree across
    ranks, so each leaf's scale is all-reduced with MAX first (one scalar
    a leaf), then the int8 values are summed as int32 and dequantized.
    Returns a new dict; the inputs are not modified."""
    import torch.distributed as dist

    def one(g):
        scale = _scale(g)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        acc = _quantize(g, scale).to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return acc.to(torch.float32) * scale

    return _map(one, tree)
