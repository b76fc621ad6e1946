"""The QO absorb's share of its roofline: the least time the card could
take for the traced steps' absorbs (``roofline.absorb`` at the (tree,
leaf) pairs each batch reaches with a positive bagging weight, routed
here by the reference from the step's pre-step trees) over the device
time of the kernels named ``qo_update_leaves*`` (the plan and the
pieces kernels)."""
import torch

from harness import roofline
from reference import arf


def read(ctx):
    if ctx.kind != "learn" or ctx.cfg["observer"] != "qo":
        return None
    us = ctx.trace.kernel_us(("qo_update_leaves",))
    if us <= 0:
        return None
    cfg = ctx.cfg
    T, M, F, C, B = (cfg["n_trees"], cfg["max_nodes"], cfg["n_features"],
                     cfg["n_bins"], cfg["batch_rows"])
    need = 0.0
    for it in ctx.items:
        t = it["trees"]
        X, w = ctx.pool["X"][it["i"]], ctx.pool["bag_w"][it["i"]]
        leaf = arf.route(t["feature"], t["threshold"], t["child"], t["is_leaf"], X,
                         cfg["max_depth"])
        gl = leaf + torch.arange(T, device=leaf.device)[:, None] * M
        touched = int(torch.unique(gl[w > 0]).numel())
        need += roofline.bound_s(*roofline.absorb(T * M, T * B, B, F, C, touched))
    return 100.0 * need / (us / 1e6)
