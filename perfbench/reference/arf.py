"""Plain PyTorch reference of one prequential step of the online-bagged
QO forest, and of the answers a frozen snapshot of it serves.

It imports nothing but torch.  States are dicts of tensors with the key
names the forest state uses (``trees``, ``feat_mask``, ``err_win``,
``err_ewma``, ``vote_w``, ``resets``; a tree's ``feature``,
``threshold``, ``child``, ``is_leaf``, ``depth``, ``ystats``, ``ao_y``,
``ao_sum_x``, ``ao_radius``, ``ao_origin``, ``seen_since_attempt``,
``dec_logE``, ``dec_n_last``, ``n_nodes``), so a comparison can read
both side by side.  Every function takes a compute dtype ``dt``: float32
is the configuration's precision, and bfloat16 gives the control that
a comparison must refuse.

A step is split where a comparison has to reconcile rounding-level
choices: :func:`prepare` (predict, bag, route, target stats, absorb, the
split query and the drift statistics), :func:`decide` (which leaves
split, on which feature and boundary, and which member is swapped), and
:func:`finish` (the splits' writes, the swap and the vote weights).

The configuration is the dict of ``configs/<name>.json``.
"""
from __future__ import annotations

import torch

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


# --------------------------------------------------------------------------
# statistics algebra (Welford, Chan's merge)
# --------------------------------------------------------------------------

def merge(a, b):
    """Chan et al.'s parallel merge of two (n, mean, m2) dicts."""
    n = a["n"] + b["n"]
    safe = torch.where(n > 0, n, torch.ones_like(n))
    delta = b["mean"] - a["mean"]
    mean = (a["n"] * a["mean"] + b["n"] * b["mean"]) / safe
    m2 = a["m2"] + b["m2"] + delta * delta * (a["n"] * b["n"]) / safe
    zero = torch.zeros_like(n)
    return {"n": n, "mean": torch.where(n > 0, mean, zero),
            "m2": torch.where(n > 0, m2, zero)}


def variance(s):
    d = s["n"] - 1
    return torch.where(d > 0, s["m2"] / torch.where(d > 0, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def observe(s, y, w):
    """Welford's weighted single-observation update."""
    n = s["n"] + w
    safe = torch.where(n > 0, n, torch.ones_like(n))
    d_pre = y - s["mean"]
    mean = s["mean"] + w * d_pre / safe
    return {"n": n, "mean": mean, "m2": s["m2"] + w * d_pre * (y - mean)}


def segment_two_pass(seg, num, w, v, dt):
    """Weighted (n, mean, m2) of v per segment id in [0, num), two-pass."""
    def add(x):
        return torch.zeros(num, dtype=dt, device=w.device).index_add_(0, seg, x)
    n = add(w)
    mean = torch.where(n > 0, add(w * v) / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.zeros_like(n))
    m2 = add(w * (v - mean[seg]) ** 2)
    return {"n": n, "mean": mean, "m2": torch.where(n > 0, m2, torch.zeros_like(m2))}


def xla_int32(v):
    """f32 -> integer as XLA casts: truncation, saturation, NaN -> 0 (int64)."""
    h = torch.nan_to_num(v.double(), nan=0.0, posinf=float(I32_MAX),
                         neginf=float(I32_MIN))
    return torch.clamp(h, I32_MIN, I32_MAX).to(torch.int64)


# --------------------------------------------------------------------------
# the forest's pieces
# --------------------------------------------------------------------------

def slots(cfg):
    return cfg["n_bins"] if cfg["observer"] == "qo" else cfg["sketch_k"]


def fresh_trees(cfg, T, device, dt=torch.float32):
    """T empty single-root trees."""
    M, F, C = cfg["max_nodes"], cfg["n_features"], slots(cfg)
    z = lambda *s: torch.zeros(s, dtype=dt, device=device)
    is_leaf = torch.zeros((T, M), dtype=torch.bool, device=device)
    is_leaf[:, 0] = True
    return {
        "feature": torch.zeros((T, M), dtype=torch.int32, device=device),
        "threshold": z(T, M),
        "child": torch.full((T, M, 2), -1, dtype=torch.int32, device=device),
        "is_leaf": is_leaf,
        "depth": torch.zeros((T, M), dtype=torch.int32, device=device),
        "ystats": {"n": z(T, M), "mean": z(T, M), "m2": z(T, M)},
        "ao_sum_x": z(T, M, F, C),
        "ao_y": {"n": z(T, M, F, C), "mean": z(T, M, F, C),
                 "m2": z(T, M, F, C)},
        "ao_radius": torch.full((T, M, F), cfg["r0"], dtype=dt, device=device),
        "ao_origin": z(T, M, F),
        "seen_since_attempt": z(T, M),
        "dec_logE": z(T, M, F),
        "dec_n_last": z(T, M),
        "n_nodes": torch.ones((T,), dtype=torch.int32, device=device),
    }


def init_forest(cfg, feat_mask, device, dt=torch.float32):
    """A fresh forest with the given (T, F) subspace masks."""
    T = cfg["n_trees"]
    z = lambda: torch.zeros((T,), dtype=dt, device=device)
    return {"trees": fresh_trees(cfg, T, device, dt),
            "feat_mask": feat_mask.to(device=device, dtype=torch.bool),
            "err_win": {"n": z(), "mean": z(), "m2": z()},
            "err_ewma": z(), "vote_w": z(),
            "resets": torch.zeros((T,), dtype=torch.int32, device=device)}


def cast_state(state, dt):
    """A copy of a forest state with every float tensor in dtype ``dt``
    (other tensors copied; keys this reference does not use dropped)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v.to(dt) if v.is_floating_point() else v.clone()
    keys = ("trees", "feat_mask", "err_win", "err_ewma", "vote_w", "resets")
    return {k: conv(state[k]) for k in keys}


def route(feature, threshold, child, is_leaf, X, plies):
    """(T, B) leaf ids: ``x[feature] <= threshold`` goes left, NaN right,
    a leaf stays where it is."""
    T, M = feature.shape
    B = X.shape[0]
    node = torch.zeros((T, B), dtype=torch.long, device=X.device)
    rows = torch.arange(B, device=X.device)[None, :].expand(T, B)
    left, right = child[..., 0].long(), child[..., 1].long()
    feature = feature.long()
    for _ in range(plies):
        x = X[rows, torch.gather(feature, 1, node)]
        nxt = torch.where(x <= torch.gather(threshold, 1, node),
                          torch.gather(left, 1, node),
                          torch.gather(right, 1, node))
        node = torch.where(torch.gather(is_leaf, 1, node), node, nxt)
    return node


def vote(yhat, wts):
    num = (wts[:, None] * yhat).sum(0)
    return num / torch.clamp(wts.sum(), min=1e-12)


def vote_weights(cfg, err_win, err_ewma):
    if cfg["vote"] == "mean":
        return torch.ones_like(err_ewma)
    seen = err_win["n"] > 0
    w = (1.0 / (err_ewma + 1e-6)) ** cfg["vote_power"]
    return torch.where(seen, w, torch.zeros_like(w))


def bin_ids(radius, origin, X, C):
    """Bin of each x in its leaf's table, with XLA's integer semantics."""
    h = xla_int32(torch.floor((X - origin) / radius)) + C // 2
    h = (h - I32_MIN) % (2 ** 32) + I32_MIN
    return torch.clamp(h, 0, C - 1)


def absorb_qo(tr, gl, X, y, w, dt):
    """Fold the routed rows into every (leaf, feature) bin table."""
    T, M, F, C = tr["ao_sum_x"].shape
    N = T * M
    B = X.shape[0]
    b = torch.arange(gl.shape[0], device=X.device) % B
    Xr, yr = X[b], y[b]
    radius = tr["ao_radius"].reshape(N, F)[gl]
    origin = tr["ao_origin"].reshape(N, F)[gl]
    bins = bin_ids(radius, origin, Xr, C)
    seg = ((gl[:, None] * F + torch.arange(F, device=X.device)[None, :]) * C
           + bins).reshape(-1)
    wr, yrr = w.repeat_interleave(F), yr.repeat_interleave(F)
    tile = segment_two_pass(seg, N * F * C, wr, yrr, dt)
    sx = torch.zeros(N * F * C, dtype=dt, device=X.device).index_add_(
        0, seg, wr * Xr.reshape(-1))
    shape = (T, M, F, C)
    ao_y = merge(tr["ao_y"], {k: v.reshape(shape) for k, v in tile.items()})
    return ao_y, tr["ao_sum_x"] + sx.reshape(shape)


def prototypes(n, sum_x):
    return torch.where(n > 0, sum_x / torch.where(n > 0, n, torch.ones_like(n)),
                       torch.full_like(n, float("inf")))


def bucket_of(mid, tot, k):
    """Rank bucket of a cumulative-weight midpoint: one division, clipped."""
    return torch.clamp(xla_int32(mid * (torch.full_like(tot, k) / tot)), 0, k - 1)


def compact(n, mean, m2, sum_x, k):
    """Compact (R, J) centroids to (R, k): sort by prototype (stable,
    empties last), bucket by cumulative-weight midpoint, reduce exactly."""
    R, J = n.shape
    order = torch.sort(prototypes(n, sum_x) + 0.0, dim=-1, stable=True).indices
    n, mean, m2, sum_x = (torch.gather(a, -1, order) for a in (n, mean, m2, sum_x))
    cumw = torch.cumsum(n, -1)
    tot = torch.clamp(cumw[:, -1:], min=1e-30)
    bucket = bucket_of(cumw - 0.5 * n, tot, k)
    seg = (torch.arange(R, device=n.device)[:, None] * k + bucket).reshape(-1)
    dt = n.dtype

    def add(v):
        return torch.zeros(R * k, dtype=dt, device=n.device).index_add_(0, seg, v.reshape(-1))
    nb, sy, sx = add(n), add(n * mean), add(sum_x)
    mb = torch.where(nb > 0, sy / torch.where(nb > 0, nb, torch.ones_like(nb)),
                     torch.zeros_like(nb))
    m2b = add(m2 + n * (mean - mb.reshape(R, k).gather(1, bucket)) ** 2)
    m2b = torch.where(nb > 0, m2b, torch.zeros_like(m2b))
    return tuple(a.reshape(R, k) for a in (nb, mb, m2b, sx))


def presketch(gl, X, y, w, N, k, dt):
    """(N, F, k) rank-bucket planes of one routed batch: per feature the
    rows sort by (leaf, x), each row's within-leaf cumulative-weight
    midpoint picks its bucket, and each bucket reduces two-pass."""
    R = gl.shape[0]
    B, F = X.shape
    dev = X.device
    b = torch.arange(R, device=dev) % B
    xT = X[b].T.contiguous()                                    # (F, R)
    yr = y[b]
    o1 = torch.sort(xT + 0.0, dim=-1, stable=True).indices
    o2 = torch.sort(gl[o1], dim=-1, stable=True).indices
    order = torch.gather(o1, -1, o2)
    leaf_s = gl[order]
    x_s = torch.gather(xT, -1, order)
    y_s, w_s = yr[order], w[order]
    # weight before each row within its leaf: all rows of the feature's
    # run minus the weight of the smaller leaves
    tot_l = torch.zeros(N, dtype=dt, device=dev).index_add_(0, gl, w)
    offset = torch.cumsum(tot_l, 0) - tot_l
    cumw = torch.cumsum(w_s, -1) - offset[leaf_s]
    tot = torch.clamp(tot_l[leaf_s], min=1e-30)
    bucket = bucket_of(cumw - 0.5 * w_s, tot, k)
    f_row = torch.arange(F, device=dev)[:, None]
    seg = ((f_row * N + leaf_s) * k + bucket).reshape(-1)
    # seg is non-decreasing along the flattened rows: each bucket is one
    # run, summed in row order (index_add's atomics would reorder the
    # sums, and the prototypes' order decides the compaction's buckets)
    ids, lengths = torch.unique_consecutive(seg, return_counts=True)

    def runsum(v):
        v = v.reshape(-1)
        if dt == torch.float32:
            return torch.segment_reduce(v, "sum", lengths=lengths)
        run = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), lengths)
        return torch.zeros(ids.numel(), dtype=dt, device=dev).index_add_(0, run, v)

    n_r, sy_r, sx_r = runsum(w_s), runsum(w_s * y_s), runsum(w_s * x_s)
    mean_r = torch.where(n_r > 0, sy_r / torch.where(n_r > 0, n_r, torch.ones_like(n_r)),
                         torch.zeros_like(n_r))
    mean_rows = torch.repeat_interleave(mean_r, lengths).reshape(F, R)
    m2_r = runsum(w_s * (y_s - mean_rows) ** 2)
    m2_r = torch.where(n_r > 0, m2_r, torch.zeros_like(m2_r))

    def place(v):
        return torch.zeros(F * N * k, dtype=dt, device=dev).index_copy_(0, ids, v)
    st = {"n": place(n_r), "mean": place(mean_r), "m2": place(m2_r)}
    sx = place(sx_r)
    out = lambda a: a.reshape(F, N, k).permute(1, 0, 2).contiguous()
    return out(st["n"]), out(st["mean"]), out(st["m2"]), out(sx)


def absorb_sketch(tr, gl, X, y, w, k, dt):
    """Pre-sketch the batch, then compact each table's 2k centroids to k."""
    T, M, F, _ = tr["ao_sum_x"].shape
    N = T * M
    bn, bmean, bm2, bsx = presketch(gl, X, y, w, N, k, dt)
    a = tr["ao_y"]
    flat = lambda v: v.reshape(N * F, -1)
    cat = lambda u, v: torch.cat([flat(u), flat(v)], -1)
    n, mean, m2, sx = compact(cat(a["n"], bn), cat(a["mean"], bmean),
                              cat(a["m2"], bm2), cat(tr["ao_sum_x"], bsx), k)
    shape = (T, M, F, k)
    return ({"n": n.reshape(shape), "mean": mean.reshape(shape),
             "m2": m2.reshape(shape)}, sx.reshape(shape))


def query(n, mean, m2, sum_x):
    """Per-boundary variance reduction and candidate threshold of R
    tables of C sorted slots: (score, cand), both (R, C); score is -inf
    where no occupied slot lies on both sides."""
    R, C = n.shape
    dev = n.device
    occ = n > 0
    grand = (n * mean).sum(-1, keepdim=True) / torch.clamp(n.sum(-1, keepdim=True), min=1.0)
    mu = mean - grand
    sy = n * mu
    sq = m2 + sy * mu
    Nl, SYl, SQl = torch.cumsum(n, -1), torch.cumsum(sy, -1), torch.cumsum(sq, -1)
    Nt, SYt, SQt = Nl[:, -1:], SYl[:, -1:], SQl[:, -1:]
    Nr, SYr, SQr = Nt - Nl, SYt - SYl, SQt - SQl

    def var(NN, SY, SQ):
        d = NN - 1.0
        m = torch.clamp(SQ - SY * SY / torch.where(NN > 0, NN, torch.ones_like(NN)), min=0.0)
        return torch.where(d > 0, m / torch.where(d > 0, d, torch.ones_like(d)),
                           torch.zeros_like(d))

    ntot = torch.clamp(Nt, min=1.0)
    vr = var(Nt, SYt, SQt) - (Nl / ntot) * var(Nl, SYl, SQl) \
        - (Nr / ntot) * var(Nr, SYr, SQr)
    idx = torch.arange(C, device=dev).expand(R, C)
    last = torch.cummax(torch.where(occ, idx, -1), dim=1).values
    after = torch.flip(torch.cummin(torch.flip(torch.where(occ, idx, C), [1]),
                                    dim=1).values, [1])
    nxt = torch.cat([after[:, 1:], torch.full((R, 1), C, dtype=idx.dtype, device=dev)], 1)
    ok = (last >= 0) & (nxt < C)
    proto = torch.where(occ, sum_x / torch.where(occ, n, torch.ones_like(n)),
                        torch.zeros_like(n))
    cand = 0.5 * (torch.gather(proto, 1, torch.clamp(last, min=0))
                  + torch.gather(proto, 1, torch.clamp(nxt, max=C - 1)))
    score = torch.where(ok, vr, torch.full_like(vr, float("-inf")))
    return score, cand


# --------------------------------------------------------------------------
# one step, in three stages
# --------------------------------------------------------------------------

def prepare(cfg, pre, X, y, bag_w, dt=torch.float32):
    """Everything of a step up to its choices.  ``pre`` is read, never
    written.  Returns a dict: the prequential ``member_mse``,
    ``forest_mse`` and ``pred`` (B,), the routed ``leaf`` ids (T, B), the
    batch's per-leaf target weight ``batch_n`` (T, M), the learned trees
    before the attempt, the ``attempt`` mask, the query's ``score`` and
    ``cand`` of every attempting table (K*F, C) with their ``rows``, the
    best ``merit`` and ``thr`` (T, M, F), and the drift statistics."""
    T, M = pre["trees"]["feature"].shape
    F = cfg["n_features"]
    X, y, bag_w = X.to(dt), y.to(dt), bag_w.to(dt)
    tr = pre["trees"]
    B = y.shape[0]
    dev = X.device
    leaf = route(tr["feature"], tr["threshold"], tr["child"], tr["is_leaf"], X,
                 cfg["max_depth"])
    yhat = torch.gather(tr["ystats"]["mean"], 1, leaf)
    member_mse = ((yhat - y[None, :]) ** 2).sum(1) / float(B)
    pred = vote(yhat, pre["vote_w"])
    forest_mse = ((pred - y) ** 2).sum() / float(B)

    gl = (torch.arange(T, device=dev)[:, None] * M + leaf).reshape(-1)
    w = bag_w.reshape(-1)
    batch = segment_two_pass(gl, T * M, w, y.repeat(T), dt)
    batch = {k: v.reshape(T, M) for k, v in batch.items()}
    learned = dict(tr, ystats=merge(tr["ystats"], batch),
                   seen_since_attempt=tr["seen_since_attempt"] + batch["n"])
    if cfg["observer"] == "qo":
        ao_y, ao_sum_x = absorb_qo(tr, gl, X, y, w, dt)
    else:
        ao_y, ao_sum_x = absorb_sketch(tr, gl, X, y, w, cfg["sketch_k"], dt)
    learned = dict(learned, ao_y=ao_y, ao_sum_x=ao_sum_x)

    attempt = learned["is_leaf"] \
        & (learned["seen_since_attempt"] >= cfg["grace_period"]) \
        & (learned["depth"] < cfg["max_depth"]) \
        & (learned["n_nodes"][:, None] + 1 < M)
    C = ao_sum_x.shape[-1]
    rows = torch.nonzero(attempt.reshape(-1)).reshape(-1)
    fold = lambda a: a.reshape(T * M, F, C)[rows].reshape(-1, C)
    planes = [fold(ao_y["n"]), fold(ao_y["mean"]), fold(ao_y["m2"]), fold(ao_sum_x)]
    if cfg["observer"] == "sketch":
        order = torch.sort(prototypes(planes[0], planes[3]) + 0.0, dim=-1,
                           stable=True).indices
        planes = [torch.gather(a, -1, order) for a in planes]
    score, cand = query(*planes)
    best = torch.argmax(score, -1)
    merit = torch.full((T * M, F), float("-inf"), dtype=dt, device=dev)
    thr = torch.zeros((T * M, F), dtype=dt, device=dev)
    if rows.numel():
        top = torch.amax(score, -1)
        pick = torch.gather(cand, 1, best[:, None])[:, 0]
        merit[rows] = top.reshape(-1, F)
        thr[rows] = torch.where(top == float("-inf"), torch.zeros_like(pick),
                                pick).reshape(-1, F)
    out = {"member_mse": member_mse, "forest_mse": forest_mse, "pred": pred,
           "leaf": leaf, "batch_n": batch["n"], "learned": learned,
           "attempt": attempt, "rows": rows, "score": score, "cand": cand,
           "merit": merit.reshape(T, M, F), "thr": thr.reshape(T, M, F)}
    out.update(_drift_stats(cfg, pre, member_mse))
    return out


def _drift_stats(cfg, pre, member_mse):
    ref = pre["err_win"]
    alpha = cfg["drift_alpha"]
    first = ref["n"] < 0.5
    ewma = torch.where(first, member_mse,
                       (1.0 - alpha) * pre["err_ewma"] + alpha * member_mse)
    sd = torch.sqrt(torch.clamp(variance(ref), min=1e-12))
    bar = ref["mean"] + cfg["drift_kappa"] * sd
    ready = ref["n"] >= cfg["drift_min_batches"]
    return {"ewma": ewma, "drift_bar": bar, "drift_ready": ready}


def decide(cfg, prep, feat_mask):
    """The reference's own choices: ``want`` (T, M) leaves that split,
    ``best_f`` (T, M) their feature, ``signal`` and ``drift`` (T,)."""
    merit = torch.where(torch.isnan(prep["merit"]), float("-inf"), prep["merit"])
    merit = torch.where(feat_mask[:, None, :], merit, float("-inf"))
    best_f = torch.argmax(merit, -1)
    top2 = torch.topk(merit, 2, dim=-1).values
    vr1, vr2 = top2[..., 0], top2[..., 1]
    n_leaf = torch.clamp(prep["learned"]["ystats"]["n"], min=1.0)
    log_d = torch.log(torch.tensor(1.0 / cfg["delta"], dtype=torch.float32,
                                   device=merit.device))
    eps = torch.sqrt(log_d / (2.0 * n_leaf.float()))
    ratio = torch.where(vr1 > 0, torch.clamp(vr2, min=0.0) / vr1, torch.ones_like(vr1))
    passes = (ratio < 1.0 - eps) | (eps < cfg["tau"])
    want = prep["attempt"] & passes & torch.isfinite(vr1) & (vr1 > 0) \
        & (torch.isfinite(merit).sum(-1) >= 2)
    signal = prep["drift_ready"] & (prep["ewma"] > prep["drift_bar"])
    worst = torch.argmax(torch.where(signal, prep["ewma"],
                                     torch.full_like(prep["ewma"], float("-inf"))))
    drift = signal & (torch.arange(signal.shape[0], device=signal.device) == worst)
    return {"want": want, "best_f": best_f, "best_c": torch.gather(
        prep["thr"], -1, best_f[..., None])[..., 0], "merit": merit,
        "vr1": vr1, "vr2": vr2, "eps": eps, "signal": signal, "drift": drift}


def _side(mask, nw, mean_b, m2_b):
    nn = (mask * nw).sum(-1)
    sy = (mask * (nw * mean_b)).sum(-1)
    safe = torch.where(nn > 0, nn, torch.ones_like(nn))
    mean = torch.where(nn > 0, sy / safe, torch.zeros_like(nn))
    m2 = (mask * m2_b).sum(-1) + (mask * nw * (mean_b - mean[:, None]) ** 2).sum(-1)
    return {"n": nn, "mean": mean, "m2": torch.where(nn > 0, m2, torch.zeros_like(m2))}


def _child_grid(cfg, occ, sum_x):
    """Children's bin radius sigma_x / sigma_k and origin mean_x."""
    proto = torch.where(occ > 0, sum_x / torch.clamp(occ, min=1.0), torch.zeros_like(occ))
    n_f = occ.sum(-1)
    mean_x = (occ * proto).sum(-1) / torch.clamp(n_f, min=1.0)
    var_x = (occ * (proto - mean_x[..., None]) ** 2).sum(-1) / torch.clamp(n_f - 1.0, min=1.0)
    sigma = torch.sqrt(torch.clamp(var_x, min=1e-12))
    return torch.clamp(sigma / cfg["sigma_k"], min=1e-6), mean_x


def finish(cfg, pre, prep, choice, new_masks):
    """Apply ``choice`` (``want``, ``best_f``, ``best_c``, ``drift``, the
    latter possibly reconciled with another run's) to the learned trees:
    child allocation and writes, the drift windows, the member swap and
    the vote weights.  Returns the post-step state."""
    tr = prep["learned"]
    T, M = tr["feature"].shape
    dev = tr["feature"].device
    attempt = prep["attempt"]
    st = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict)
              else v.clone()) for k, v in tr.items()}
    if bool(attempt.any()):
        want, best_f, best_c = choice["want"], choice["best_f"], choice["best_c"]
        k = torch.cumsum(want.to(torch.int32), -1, dtype=torch.int32) - 1
        base = tr["n_nodes"][:, None] + 2 * k
        can = want & (base + 1 < M)
        pt, pm = torch.nonzero(can, as_tuple=True)
        c0 = base[pt, pm].long()
        kt, km = torch.cat([pt, pt]), torch.cat([c0, c0 + 1])
        st["feature"][pt, pm] = best_f[pt, pm].to(torch.int32)
        st["threshold"][pt, pm] = best_c[pt, pm].to(st["threshold"].dtype)
        st["child"][pt, pm] = torch.stack([c0, c0 + 1], 1).to(torch.int32)
        st["child"][kt, km] = -1
        st["is_leaf"][pt, pm] = False
        st["is_leaf"][kt, km] = True
        st["seen_since_attempt"][pt, pm] = 0.0
        st["seen_since_attempt"][kt, km] = 0.0
        st["depth"][kt, km] = (tr["depth"][pt, pm] + 1).repeat(2)
        for key in ("dec_logE", "dec_n_last"):
            st[key][pt, pm] = 0.0
            st[key][kt, km] = 0.0
        ao_y, sx = tr["ao_y"], tr["ao_sum_x"]
        bf = best_f[pt, pm]
        n_f, sx_f = ao_y["n"][pt, pm, bf], sx[pt, pm, bf]
        occ = n_f > 0
        proto = torch.where(occ, sx_f / torch.where(occ, n_f, torch.ones_like(n_f)),
                            torch.full_like(n_f, float("inf")))
        maskL = (occ & (proto <= best_c[pt, pm][:, None])).to(n_f.dtype)
        maskR = occ.to(n_f.dtype) - maskL
        mean_f, m2_f = ao_y["mean"][pt, pm, bf], ao_y["m2"][pt, pm, bf]
        left, right = _side(maskL, n_f, mean_f, m2_f), _side(maskR, n_f, mean_f, m2_f)
        for key in ("n", "mean", "m2"):
            st["ystats"][key][kt, km] = torch.cat([left[key], right[key]])
        child_r, mean_x = _child_grid(cfg, ao_y["n"][pt, pm], sx[pt, pm])
        st["ao_radius"][kt, km] = child_r.repeat(2, 1)
        st["ao_origin"][kt, km] = mean_x.repeat(2, 1)
        for plane in (st["ao_y"]["n"], st["ao_y"]["mean"], st["ao_y"]["m2"],
                      st["ao_sum_x"]):
            plane[kt, km] = 0.0
        st["n_nodes"] = tr["n_nodes"] + 2 * can.sum(-1, dtype=torch.int32)
        st["seen_since_attempt"] = torch.where(
            attempt & ~can, torch.zeros_like(st["seen_since_attempt"]),
            st["seen_since_attempt"])

    # drift windows: a signalling member's window freezes; the others
    # decay by drift_decay and observe this batch's error
    ref = pre["err_win"]
    member_mse = prep["member_mse"]
    signal, drift = choice["signal"], choice["drift"]
    d = torch.tensor(cfg["drift_decay"], dtype=member_mse.dtype, device=dev)
    observed = observe({"n": d * ref["n"], "mean": ref["mean"], "m2": d * ref["m2"]},
                       member_mse, 1.0)
    win = {k: torch.where(signal, ref[k], observed[k]) for k in observed}
    feat_mask = pre["feat_mask"]
    if bool(drift.any()):
        fresh = fresh_trees(cfg, T, dev, st["threshold"].dtype)

        def swap(a, f):
            return torch.where(drift.reshape((T,) + (1,) * (a.dim() - 1)), f, a)
        st = {k: ({kk: swap(vv, fresh[k][kk]) for kk, vv in v.items()}
                  if isinstance(v, dict) else swap(v, fresh[k]))
              for k, v in st.items()}
        feat_mask = torch.where(drift[:, None], new_masks.to(torch.bool), feat_mask)
    zero = torch.zeros_like(member_mse)
    err_win = {k: torch.where(drift, zero, v) for k, v in win.items()}
    err_ewma = torch.where(drift, zero, prep["ewma"])
    return {"trees": st, "feat_mask": feat_mask, "err_win": err_win,
            "err_ewma": err_ewma, "vote_w": vote_weights(cfg, err_win, err_ewma),
            "resets": pre["resets"] + drift.to(torch.int32)}


def step(cfg, pre, X, y, bag_w, new_masks, dt=torch.float32):
    """One whole step on the reference's own choices: (post, prep, choice)."""
    prep = prepare(cfg, pre, X, y, bag_w, dt)
    choice = decide(cfg, prep, pre["feat_mask"])
    return finish(cfg, pre, prep, choice, new_masks), prep, choice


def serve(cfg, state, X, dt=torch.float32):
    """The answers a snapshot of ``state`` serves for rows X (B, F): the
    vote of the members' leaf means, routed through the live trees."""
    tr = state["trees"]
    X = X.to(dt)
    leaf = route(tr["feature"], tr["threshold"].to(dt), tr["child"], tr["is_leaf"],
                 X, cfg["max_depth"])
    yhat = torch.gather(tr["ystats"]["mean"].to(dt), 1, leaf)
    return vote(yhat, state["vote_w"].to(dt))

