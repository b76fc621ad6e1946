"""int8-quantized all-reduce (the reference's ``optim/compress.py``,
DESIGN.md §4.2): per-leaf symmetric int8 quantization before the sum,
dequantization after.  The wire carries int8-range integers (summed as
int32) and one f32 scale a leaf; the data-parallel trainer ships its
sync deltas through it with ``compress="int8"``.

``sparsify_with_sketch`` (QO-thresholded top-k gradient sparsification)
feeds the LM gradients of the reference, not this path, and is not here
(ROADMAP A14).
"""
from __future__ import annotations

import torch

__all__ = ["int8_encode", "int8_decode", "quantized_all_reduce"]


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

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else one(t)

    return walk(tree)
