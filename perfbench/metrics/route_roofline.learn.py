"""The learn step's route kernels' share of their roofline over the
traced steps: the least time the card could take (``roofline.route`` with
the nodes each step's batch visits in its pre-step trees, counted once a
route, and the plies it walks, routed here by the reference's rule) times
the route launches a step, over the device time of the kernels named
``qo_route*`` in the learn window.  Nothing when the window ran no route
kernel."""
import torch

from harness import roofline, trace


def visited(feature, threshold, child, is_leaf, X, plies):
    """(distinct (tree, node) pairs the rows visit, non-leaf visits): the
    walk of ``reference.arf.route``, keeping every ply's nodes."""
    T, M = feature.shape
    B = X.shape[0]
    node = torch.zeros((T, B), dtype=torch.long, device=X.device)
    rows = torch.arange(B, device=X.device)[None, :].expand(T, B)
    tree = torch.arange(T, device=X.device)[:, None] * M
    left, right = child[..., 0].long(), child[..., 1].long()
    feature = feature.long()
    seen, walked = [torch.unique(tree + node)], 0
    for _ in range(plies):
        leaf = torch.gather(is_leaf, 1, node)
        walked += int((~leaf).sum())
        x = X[rows, torch.gather(feature, 1, node)]
        nxt = torch.where(x <= torch.gather(threshold, 1, node),
                          torch.gather(left, 1, node), torch.gather(right, 1, node))
        node = torch.where(leaf, node, nxt)
        seen.append(torch.unique(tree + node))
    return int(torch.unique(torch.cat(seen)).numel()), walked


def read(ctx):
    if ctx.kind != "learn" or not ctx.n or not ctx.items:
        return None
    tr = ctx.trace
    us = tr.kernel_us(("qo_route",))
    if us <= 0:
        return None
    launches = sum(1 for name, cat, _, _ in tr.device
                   if cat == "kernel" and trace.kernel_name(name).startswith("qo_route"))
    cfg = ctx.cfg
    T, F = cfg["n_trees"], cfg["n_features"]
    need = 0.0
    for it in ctx.items:
        t = it["trees"]
        X = ctx.pool["X"][it["i"]]
        nodes, walked = visited(t["feature"], t["threshold"], t["child"], t["is_leaf"], X,
                                cfg["max_depth"])
        need += roofline.bound_s(*roofline.route(T, X.shape[0], F, nodes, walked))
    need *= launches / ctx.n
    return 100.0 * need / (us / 1e6)
