"""The snapshot route's share of its roofline over the traced requests:
the least time the card could take (``roofline.route`` with the nodes
each request's rows visit, counted once a request, and the plies they
walk, routed here over the snapshot's arrays) over the device time of
the kernels named ``qo_route*``."""
import torch

from harness import roofline


def read(ctx):
    if ctx.kind != "serve":
        return None
    us = ctx.trace.kernel_us(("qo_route",))
    if us <= 0 or not ctx.items:
        return None
    snap = ctx.snapshot
    T, Mr = snap.feature.shape
    F = ctx.requests.shape[1]
    dev = snap.feature.device
    req = torch.cat([torch.full((s,), j, dtype=torch.long)
                     for j, (_, s) in enumerate(ctx.items)]).to(dev)
    X = torch.cat([torch.as_tensor(ctx.requests[o:o + s]) for o, s in ctx.items]).to(dev)
    R = X.shape[0]
    rows = torch.arange(R, device=dev)[None, :].expand(T, R)
    tree = torch.arange(T, device=dev)[:, None]
    node = torch.zeros((T, R), dtype=torch.long, device=dev)
    left, right = snap.child[..., 0].long(), snap.child[..., 1].long()
    feature = snap.feature.long()

    def keys(nd):
        return torch.unique((req[None, :] * T + tree) * Mr + nd)
    seen, walked = [keys(node)], 0
    for _ in range(snap.depth):
        leaf = torch.gather(snap.is_leaf, 1, node)
        walked += int((~leaf).sum())
        x = X[rows, torch.gather(feature, 1, node)]
        nxt = torch.where(x <= torch.gather(snap.threshold, 1, node),
                          torch.gather(left, 1, node), torch.gather(right, 1, node))
        node = torch.where(leaf, node, nxt)
        seen.append(keys(node))
    nodes = int(torch.unique(torch.cat(seen)).numel())
    nbytes, flops = roofline.route(T, R, F, nodes, walked)
    need = max(nbytes / roofline.HBM_BYTES_PER_S, flops / roofline.FP32_FLOPS_PER_S)
    return 100.0 * need / (us / 1e6)
