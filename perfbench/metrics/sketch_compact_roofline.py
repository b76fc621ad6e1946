"""The sketch compaction's share of its roofline: the least time the card
could take to compact, each traced step, the 2K centroids of every live
leaf's F tables into K (``roofline.compact``; tables of internal and
unallocated nodes are never read again, so they are not counted) over
the device time of the kernels named ``sketch_compact*``."""
import torch

from harness import roofline


def read(ctx):
    if ctx.kind != "learn" or ctx.cfg["observer"] != "sketch":
        return None
    us = ctx.trace.kernel_us(("sketch_compact",))
    if us <= 0:
        return None
    cfg = ctx.cfg
    M, F, K = cfg["max_nodes"], cfg["n_features"], cfg["sketch_k"]
    need = 0.0
    for it in ctx.items:
        t = it["trees"]
        alloc = torch.arange(M, device=t["is_leaf"].device)[None, :] < t["n_nodes"][:, None]
        live = int((t["is_leaf"] & alloc).sum())
        need += roofline.bound_s(*roofline.compact(live * F, 2 * K, K))
    return 100.0 * need / (us / 1e6)
