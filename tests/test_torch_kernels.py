"""Port parity: the forest kernel modules of ``repro_torch.kernels`` (the
single-table and sketch ones: ``test_torch_qo.py``, ``test_torch_sketch.py``).

Each plain PyTorch version (what a wrapper runs on a CPU tensor) is held
against the JAX package's op on the same numpy inputs, through both of
its paths: ``backend="interpret"`` (the Pallas kernel body) and
``backend="jnp"`` (the fused lowering).  Ids, bin ids and -inf patterns
must match exactly; f32 statistics, merits and thresholds within 1e-4
(``tests/test_qo_batched.py``'s tolerance).

``TestOnCard`` holds each CUDA kernel against its plain version; it needs
a GPU and skips without one.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.core import sketch as tsk
from repro_torch.kernels import (leaf_stats, qo_merge, qo_query,
                                 qo_query_batched, qo_route, qo_update,
                                 qo_update_leaves, sketch_compact)
from repro_torch.kernels.qo_update_leaves import xla_int32

TOL = 1e-4
BACKENDS = ("jnp", "interpret")


def random_trees(rng, T, M, F, splits):
    """T random trees grown by splitting random leaves, children allocated
    in pairs as the reference allocates them."""
    feature = np.zeros((T, M), np.int32)
    thr = np.zeros((T, M), np.float32)
    child = np.full((T, M, 2), -1, np.int32)
    is_leaf = np.zeros((T, M), bool)
    depth = np.zeros((T, M), np.int32)
    for t in range(T):
        is_leaf[t, 0] = True
        n = 1
        for _ in range(splits[t] if np.ndim(splits) else splits):
            if n + 2 > M:
                break
            u = rng.choice(np.nonzero(is_leaf[t, :n])[0])
            feature[t, u] = rng.integers(F)
            thr[t, u] = rng.normal(0, 0.7)
            child[t, u] = (n, n + 1)
            is_leaf[t, u] = False
            is_leaf[t, n:n + 2] = True
            depth[t, n:n + 2] = depth[t, u] + 1
            n += 2
    return feature, thr, child, is_leaf, depth


def rows_with_extremes(rng, B, F):
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    X[0, :] = np.nan
    if B > 3:
        X[1, 0], X[2, -1], X[3, 0] = np.inf, -np.inf, np.nan
    return X


def route_both(feature, thr, child, is_leaf, X, depth):
    ref = {b: np.asarray(jops.forest_route(
        jnp.asarray(feature), jnp.asarray(thr), jnp.asarray(child),
        jnp.asarray(is_leaf), jnp.asarray(X), depth=depth, backend=b))
        for b in BACKENDS}
    port = tops.forest_route(torch.tensor(feature), torch.tensor(thr),
                             torch.tensor(child), torch.tensor(is_leaf),
                             torch.tensor(X), depth=depth).numpy()
    return ref, port


@pytest.mark.parametrize("B", [1, 37, 256])
def test_route_plain_matches_reference(B):
    rng = np.random.default_rng(B)
    T, M, F = 3, 63, 4
    feature, thr, child, is_leaf, depth = random_trees(rng, T, M, F,
                                                       [0, 1, 25])
    X = rows_with_extremes(rng, B, F)
    d = int(depth.max())
    ref, port = route_both(feature, thr, child, is_leaf, X, d)
    for b in BACKENDS:
        np.testing.assert_array_equal(port, ref[b], err_msg=b)
    assert port.dtype == np.int32 and port.shape == (T, B)
    # an untrained tree (root only) routes every row, NaN included, to 0
    assert (port[0] == 0).all()
    # extra plies are self-loop no-ops
    _, deeper = route_both(feature, thr, child, is_leaf, X, d + 3)
    np.testing.assert_array_equal(deeper, port)


def test_route_plain_stops_early_under_a_max_depth_bound():
    """The learn and predict paths bound the route by ``max_depth`` (no
    host read of the realized depth): the plain sweep stops once every row
    sits at a leaf, so the ids under the default bound (12) and under a
    bound of 10**9 plies are the reference's at the realized depth."""
    rng = np.random.default_rng(5)
    T, M, F, B = 4, 63, 4, 200
    feature, thr, child, is_leaf, depth = random_trees(rng, T, M, F,
                                                       [0, 3, 12, 30])
    X = rows_with_extremes(rng, B, F)
    d = int(depth.max())
    assert d < 12
    ref, _ = route_both(feature, thr, child, is_leaf, X, d)
    trees = [torch.tensor(a) for a in (feature, thr, child, is_leaf)]
    for bound in (12, 10**9):
        port = tops.forest_route(*trees, torch.tensor(X), depth=bound)
        for b in BACKENDS:
            np.testing.assert_array_equal(port.numpy(), ref[b], err_msg=b)


def test_route_single_tree_view_and_chain():
    """A max-depth chain tree through the single-tree ``route``."""
    M, F = 15, 2
    feature = np.zeros(M, np.int32)
    thr = np.zeros(M, np.float32)
    child = np.full((M, 2), -1, np.int32)
    is_leaf = np.ones(M, bool)
    for u, node in enumerate(range(0, M - 2, 2)):
        is_leaf[node] = False
        thr[node] = -1.0 + 0.25 * u
        child[node] = (node + 1, node + 2)
    X = np.linspace(-2, 2, 40, dtype=np.float32)[:, None].repeat(F, 1)
    X[5] = np.nan
    ref = np.asarray(jops.route(jnp.asarray(feature), jnp.asarray(thr),
                                jnp.asarray(child), jnp.asarray(is_leaf),
                                jnp.asarray(X), depth=7, backend="jnp"))
    port = tops.route(torch.tensor(feature), torch.tensor(thr),
                      torch.tensor(child), torch.tensor(is_leaf),
                      torch.tensor(X), depth=7).numpy()
    np.testing.assert_array_equal(port, ref)
    assert port[5] == M - 1      # NaN goes right at every ply


def test_bin_ids_at_extreme_x_match_reference():
    """ROADMAP C1: 1e10 and +inf land in bin 0 (int32 wraparound), NaN in
    bin C/2 (XLA casts NaN to 0), -inf and -1e10 in bin 0."""
    C = 64
    vals = np.array([1e10, np.inf, -np.inf, np.nan, -1e10, 3e9, 2.1e9,
                     -2.2e9, 0.5, -0.5, 31.9, 40.0, -40.0], np.float32)
    X = vals[:, None].repeat(2, 1)
    radius = np.array([[1.0, 0.3]], np.float32)
    origin = np.array([[0.0, 0.25]], np.float32)
    leaf = np.zeros(len(vals), np.int32)
    ref = np.asarray(jops.forest_bin_ids(
        jnp.asarray(radius), jnp.asarray(origin), jnp.asarray(leaf),
        jnp.asarray(X), C))
    port = tops.forest_bin_ids(torch.tensor(radius), torch.tensor(origin),
                               torch.tensor(leaf), torch.tensor(X),
                               C).numpy()
    np.testing.assert_array_equal(port, ref)
    assert list(port[:5, 0]) == [0, 0, 0, C // 2, 0]


def random_tables(rng, N, F, C, occupied=0.6):
    """Random running tables: integer counts, empty bins zeroed."""
    n = (rng.integers(1, 6, (N, F, C)) * (rng.random((N, F, C)) < occupied)
         ).astype(np.float32)
    mean = np.where(n > 0, rng.normal(1, 2, (N, F, C)), 0).astype(np.float32)
    m2 = np.where(n > 1, rng.uniform(0, 3, (N, F, C)), 0).astype(np.float32)
    sum_x = np.where(n > 0, n * rng.normal(0, 1, (N, F, C)), 0
                     ).astype(np.float32)
    return {"n": n, "mean": mean, "m2": m2}, sum_x


def absorb_both(tab_y, sum_x, radius, origin, leaf, X, y, w, T):
    """Reference (X, y tiled T times, as the forest passes them) and the
    port (folded rows, X indexed by row % B), both from the same tables."""
    Xt, yt = np.tile(X, (T, 1)), np.tile(y, T)
    ref = {}
    for b in BACKENDS:
        ry, rsx = jops.forest_update(
            {k: jnp.asarray(v) for k, v in tab_y.items()}, jnp.asarray(sum_x),
            jnp.asarray(radius), jnp.asarray(origin), jnp.asarray(leaf),
            jnp.asarray(Xt), jnp.asarray(yt), jnp.asarray(w), backend=b)
        ref[b] = ({k: np.asarray(v) for k, v in ry.items()}, np.asarray(rsx))
    py = {k: torch.tensor(v) for k, v in tab_y.items()}
    psx = torch.tensor(sum_x)
    tops.forest_update(py, psx, torch.tensor(radius), torch.tensor(origin),
                       torch.tensor(leaf), torch.tensor(X), torch.tensor(y),
                       torch.tensor(w))
    return ref, ({k: v.numpy() for k, v in py.items()}, psx.numpy())


@pytest.mark.parametrize("B", [1, 37, 129])
def test_absorb_plain_matches_reference_ragged_weighted(B):
    rng = np.random.default_rng(100 + B)
    T, M, F, C = 2, 9, 3, 48
    N = T * M
    tab_y, sum_x = random_tables(rng, N, F, C)
    radius = rng.uniform(0.05, 0.4, (N, F)).astype(np.float32)
    origin = rng.normal(0, 0.5, (N, F)).astype(np.float32)
    # leaves 0 and M (each tree's root) get no rows
    leaf = np.concatenate([t * M + rng.integers(1, M, B)
                           for t in range(T)]).astype(np.int32)
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    y = rng.normal(0, 2, B).astype(np.float32)
    w = rng.poisson(3.0, T * B).astype(np.float32)
    ref, (py, psx) = absorb_both(tab_y, sum_x, radius, origin, leaf, X, y,
                                 w, T)
    for b in BACKENDS:
        ry, rsx = ref[b]
        np.testing.assert_array_equal(py["n"], ry["n"], err_msg=b)
        for k in ("mean", "m2"):
            np.testing.assert_allclose(py[k], ry[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{b}:{k}")
        np.testing.assert_allclose(psx, rsx, rtol=TOL, atol=TOL, err_msg=b)
    for empty in (0, M):
        np.testing.assert_array_equal(py["n"][empty], tab_y["n"][empty])


def test_absorb_single_bin_and_zero_weight_rows():
    """A huge radius puts every row of x in [0, 1) into bin C/2; weight-0
    rows are no-ops to every statistic."""
    rng = np.random.default_rng(7)
    N, F, C, B = 4, 2, 32, 50
    tab_y = {k: np.zeros((N, F, C), np.float32) for k in ("n", "mean", "m2")}
    sum_x = np.zeros((N, F, C), np.float32)
    radius = np.full((N, F), 1e6, np.float32)
    origin = np.zeros((N, F), np.float32)
    leaf = rng.integers(0, N, B).astype(np.int32)
    X = rng.uniform(0, 1, (B, F)).astype(np.float32)
    y = rng.normal(0, 1, B).astype(np.float32)
    w = (rng.random(B) < 0.5).astype(np.float32)
    ref, (py, psx) = absorb_both(tab_y, sum_x, radius, origin, leaf, X, y,
                                 w, 1)
    occ = py["n"] > 0
    assert occ[..., :C // 2].sum() == 0 and occ[..., C // 2 + 1:].sum() == 0
    np.testing.assert_array_equal(py["n"], ref["jnp"][0]["n"])
    np.testing.assert_allclose(py["m2"], ref["jnp"][0]["m2"], rtol=TOL,
                               atol=TOL)
    assert float(py["n"].sum()) == F * float(w.sum())


# --------------------------------------------------------------------------
# the kernels' summation order, modelled in numpy (float32) and held against
# the reference: pieces with their own two-pass statistics, Chan-merged in
# piece order, then into the running table
# --------------------------------------------------------------------------

def _piece_stats(ids, x, y, w, C):
    """(n, mean, m2, sum wx) per bin of one piece, rows in order."""
    n, sy, sx, m2 = (np.zeros(C, np.float32) for _ in range(4))
    np.add.at(n, ids, w)
    np.add.at(sy, ids, w * y)
    np.add.at(sx, ids, w * x)
    mean = np.where(n > 0, sy / np.where(n > 0, n, 1), 0).astype(np.float32)
    d = y - mean[ids]
    np.add.at(m2, ids, w * (d * d))
    return n, mean, m2, sx


def _chan(a, b):
    """Chan merge (Eqs. 4-5) of (n, mean, m2) b into a, as the kernels."""
    (n0, m0, q0), (nb, mb, qb) = a, b
    n = n0 + nb
    safe = np.where(n > 0, n, 1).astype(np.float32)
    delta = mb - m0
    mean = (n0 * m0 + nb * mb) / safe
    m2 = q0 + qb + delta * delta * (n0 * nb) / safe
    return (n, np.where(n > 0, mean, 0).astype(np.float32),
            np.where(n > 0, m2, 0).astype(np.float32))


def _merge_pieces(parts):
    """Partials merged in piece order: ((n, mean, m2), sum wx)."""
    acc, sx = parts[0][:3], parts[0][3].copy()
    for p in parts[1:]:
        acc = _chan(acc, p[:3])
        sx = sx + p[3]
    return acc, sx


def _assert_sum_x(mine, ref, what):
    """sum_x within 1e-4.  The Pallas bodies (``interpret``) contract a
    one-hot matrix with x, so a non-finite x spreads NaN into every bin of
    its table (inf * 0); there only the bins the reference keeps finite
    are compared, and the model's non-finite bins must be non-finite in
    the reference too (ROADMAP C10)."""
    if what == "interpret":
        assert not np.isfinite(ref[~np.isfinite(mine)]).any(), what
        keep = np.isfinite(ref)
        mine, ref = mine[keep], ref[keep]
    np.testing.assert_allclose(mine, ref, rtol=TOL, atol=TOL,
                               err_msg=f"{what}:sum_x")


def _bins(radius, origin, x, C):
    return qo_update_leaves.bin_ids_plain(
        torch.tensor(radius), torch.tensor(origin), torch.tensor(x),
        C).numpy().astype(np.int64)


def model_forest_absorb(tab_y, sum_x, radius, origin, gl, X, y, w, R):
    """``csrc/qo_update_leaves.cu``'s order: rows sorted by leaf (stable),
    each leaf's run cut into pieces of R rows, every piece reduced on its
    own, the pieces of a leaf merged in order, then into its tables.
    Leaves without rows stay untouched."""
    C = sum_x.shape[2]
    B = X.shape[0]
    out_y = {k: v.copy() for k, v in tab_y.items()}
    out_sx = sum_x.copy()
    order = np.argsort(gl, kind="stable")
    with np.errstate(invalid="ignore", over="ignore"):
        for leaf in np.unique(gl):
            run = order[gl[order] == leaf]
            pieces = [run[i:i + R] for i in range(0, len(run), R)]
            for f in range(X.shape[1]):
                parts = []
                for p in pieces:
                    xs = X[p % B, f]
                    parts.append(_piece_stats(
                        _bins(radius[leaf, f], origin[leaf, f], xs, C), xs,
                        y[p % B], w[p], C))
                batch, sx = _merge_pieces(parts)
                cell = tuple(out_y[k][leaf, f] for k in ("n", "mean", "m2"))
                for k, v in zip(("n", "mean", "m2"), _chan(cell, batch)):
                    out_y[k][leaf, f] = v
                out_sx[leaf, f] = out_sx[leaf, f] + sx
    return out_y, out_sx


def skewed_absorb_case(name):
    """Inputs where the pieces matter: T=2 trees, B=600 rows a tree."""
    rng = np.random.default_rng(len(name))
    T, M, F, C, B = 2, 7, 3, 16, 600
    R = qo_update_leaves.PIECE_ROWS
    N = T * M
    tab_y, sum_x = random_tables(rng, N, F, C)
    radius = rng.uniform(0.2, 0.6, (N, F)).astype(np.float32)
    origin = rng.normal(0, 0.3, (N, F)).astype(np.float32)
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    y = rng.normal(0, 2, B).astype(np.float32)
    w = rng.poisson(2.0, T * B).astype(np.float32)
    # tree 0: its root holds the whole batch (pieces of R, R, B - 2R rows);
    # tree 1: runs of exactly R and R + 1 rows and the rest
    leaf = np.concatenate([np.zeros(B, np.int32),
                           np.repeat([M + 1, M + 2, M + 3],
                                     [R, R + 1, B - 2 * R - 1])])
    leaf[B:] = rng.permutation(leaf[B:])
    if name == "one_bin":
        radius[:] = 1e6                     # every x in [0, 1) -> bin C/2
        origin[:] = 0.0
        X = rng.uniform(0, 1, (B, F)).astype(np.float32)
        w = (rng.random(T * B) < 0.6).astype(np.float32)
    elif name == "extremes":
        X[:6, 0] = [1e10, np.inf, -np.inf, np.nan, 0.0, -0.0]
        X[6:12, 1] = [-1e10, np.nan, 0.0, -0.0, np.inf, 3e9]
        w[:50] = 0.0                        # weight-0 rows are no-ops
    return (tab_y, sum_x, radius, origin, leaf.astype(np.int32), X, y, w,
            T, R)


@pytest.mark.parametrize("name", ["whole_batch", "one_bin", "extremes"])
def test_absorb_piece_order_matches_reference(name):
    """The forest absorb kernel's order (pieces of PIECE_ROWS rows, merged
    in piece order) against the reference on both paths, n exact, the rest
    within 1e-4; the port's plain version agrees too."""
    tab_y, sum_x, radius, origin, leaf, X, y, w, T, R = \
        skewed_absorb_case(name)
    my, msx = model_forest_absorb(tab_y, sum_x, radius, origin, leaf, X, y,
                                  w, R)
    ref, plain = absorb_both(tab_y, sum_x, radius, origin, leaf, X, y, w, T)
    for what, (ry, rsx) in dict(ref, plain=plain).items():
        np.testing.assert_array_equal(my["n"], ry["n"], err_msg=what)
        for k in ("mean", "m2"):
            np.testing.assert_allclose(my[k], ry[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{what}:{k}")
        _assert_sum_x(msx, rsx, what)
    if name == "one_bin":
        C = sum_x.shape[2]
        fresh = my["n"] - tab_y["n"]
        assert not fresh[..., :C // 2].any() and \
            not fresh[..., C // 2 + 1:].any()


def test_sort_rows_offsets_and_out_of_range_ids():
    """``sort_rows`` takes the offsets from the sorted ids (no bincount):
    the runs of in-range ids match a bincount's prefix, and an id outside
    [0, n) lies outside every run, which the segment statistics refuse."""
    from repro_torch.core import hoeffding as tht
    rng = np.random.default_rng(11)
    gl = rng.integers(0, 9, 300).astype(np.int32)
    order, offsets = tops.sort_rows(torch.tensor(gl), 12)
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(gl, kind="stable"))
    np.testing.assert_array_equal(
        offsets.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(gl, minlength=12))]))
    y, w = torch.ones(300), torch.ones(300)
    for bad in (12, -1):
        g = gl.copy()
        g[17] = bad
        _, off = tops.sort_rows(torch.tensor(g), 12)
        assert int(off[-1] - off[0]) == 299
        with pytest.raises(RuntimeError, match="lengths"):
            tht.segment_stats(y, torch.tensor(g), 12, w)


def model_leaf_stats(ystats, seen, rows, y, w):
    """``csrc/leaf_stats.cu``'s order in float32: lane l of an entry's warp
    sums the entry's sorted rows l, l + 32, ... in order, a xor butterfly
    over lane offsets 16 .. 1 folds the 32 lanes, mean = sum wy / n, and a
    second pass sums w (y - mean)^2 the same way; then ``stats.merge``
    into every running entry and n added to ``seen``.  CPU tensors in,
    new ``(ystats, seen)`` out."""
    from repro_torch.core import stats as tst
    order, offsets = (t.cpu().long() for t in rows)
    N, B = seen.shape[0], y.shape[0]
    at = torch.arange(int(offsets[0]), int(offsets[-1]))
    e = torch.repeat_interleave(torch.arange(N), offsets.diff())
    pos = at - offsets[e]
    lane, step = pos % 32, pos // 32
    r = order[at]
    wv, yv = w.cpu()[r], y.cpu()[r % B]
    butterfly = [torch.arange(32) ^ off for off in (16, 8, 4, 2, 1)]

    def lanes_sum(v):
        acc = torch.zeros((N, 32), dtype=torch.float32)
        for s_ in range(int(step.max()) + 1 if step.numel() else 0):
            k = step == s_
            acc[e[k], lane[k]] = acc[e[k], lane[k]] + v[k]
        for perm in butterfly:
            acc = acc + acc[:, perm]
        return acc[:, 0]

    n, sy = lanes_sum(wv), lanes_sum(wv * yv)
    mean = torch.where(n > 0, sy / torch.where(n > 0, n, 1.0), 0.0)
    d = yv - mean[e]
    m2 = torch.where(n > 0, lanes_sum(wv * (d * d)), 0.0)
    batch = {"n": n, "mean": mean, "m2": m2}
    return (tst.merge({k: v.cpu() for k, v in ystats.items()}, batch),
            seen.cpu() + n)


def leaf_stats_case(name):
    """(ystats, seen, gl, y, w) of one call: running statistics on every
    entry (some empty), integer Poisson weights with zero-weight rows.
    ``whole_batch``: tree 0's root holds its whole 4,096-row batch (a
    fresh tree) beside a tree whose rows spread; ``single_rows``: runs of
    one row between empty runs; ``zero_weight``: runs whose rows all weigh
    0 beside runs of one live row among dead ones; ``full``: the main
    path's T*M = 10,230 entries and B = 4,096 rows, one tree fresh."""
    rng = np.random.default_rng(sum(map(ord, name)))
    T, M, B = {"whole_batch": (2, 7, 4096), "single_rows": (3, 40, 10),
               "zero_weight": (2, 15, 64), "full": (10, 1023, 4096)}[name]
    if name == "whole_batch":
        leaf = np.stack([np.zeros(B), rng.integers(0, M, B)])
    elif name == "single_rows":
        leaf = np.stack([rng.permutation(M)[:B] for _ in range(T)])
    elif name == "zero_weight":
        leaf = rng.integers(0, 4, (T, B))
    else:
        # a spread over a tree's leaves as a grown tree routes: skewed
        p = rng.pareto(1.0, M) + 1e-3
        leaf = np.stack([rng.choice(M, B, p=p / p.sum()) for _ in range(T)])
        leaf[3] = 0
    gl = (np.arange(T)[:, None] * M + leaf).astype(np.int32).reshape(-1)
    w = rng.poisson(6.0, T * B).astype(np.float32)
    w[rng.random(T * B) < 0.2] = 0.0
    if name == "zero_weight":
        w[leaf.reshape(-1) == 1] = 0.0
        w[(leaf.reshape(-1) == 2)] = 0.0
        w[np.flatnonzero(leaf.reshape(-1) == 2)[:1]] = 3.0
    y = rng.normal(1.5, 2.0, B).astype(np.float32)
    n = np.where(rng.random(T * M) < 0.7,
                 rng.integers(1, 5000, T * M), 0).astype(np.float32)
    ystats = {"n": n,
              "mean": np.where(n > 0, rng.normal(1.0, 2.0, T * M), 0),
              "m2": np.where(n > 0, n * rng.uniform(0.5, 5.0, T * M), 0)}
    seen = rng.integers(0, 300, T * M).astype(np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return ({k: t(v) for k, v in ystats.items()}, t(seen),
            torch.tensor(gl), t(y), t(w))


LEAF_STATS_CASES = ("whole_batch", "single_rows", "zero_weight", "full")


@pytest.mark.parametrize("name", LEAF_STATS_CASES)
def test_leaf_stats_order_model_matches_plain(name):
    """The kernel's order against the plain version (today's composition:
    ``segment_stats``, ``stats.merge``, the seen add): n and seen exact
    (integer weights), mean and M2 within 1e-4 -- the two sum each run in
    another order (sequential against 32 lanes and a butterfly), which
    moves a 4,096-row float32 sum by about 1e-6 of its size; an entry the
    batch missed is ``stats.merge`` with an empty batch, bit for bit."""
    from repro_torch.core import stats as tst
    ystats, seen, gl, y, w = leaf_stats_case(name)
    N = seen.shape[0]
    rows = tops.sort_rows(gl, N)
    bad = torch.ones(1, dtype=torch.bool)
    py, ps = leaf_stats.leaf_stats(ystats, seen, gl, y, w, rows, bad)
    assert not bool(bad)
    my, ms = model_leaf_stats(ystats, seen, rows, y, w)
    assert torch.equal(my["n"], py["n"]) and torch.equal(ms, ps)
    for k in ("mean", "m2"):
        torch.testing.assert_close(my[k], py[k], rtol=TOL, atol=TOL)
    empty = rows[1].diff() == 0
    assert bool(empty.any())
    untouched = tst.merge(ystats, tst.init((N,)))
    for k in ("n", "mean", "m2"):
        assert torch.equal(my[k][empty], untouched[k][empty]), k
        assert torch.equal(py[k][empty], untouched[k][empty]), k
    if name == "whole_batch":
        assert int(rows[1][1] - rows[1][0]) == y.shape[0]
    if name == "zero_weight":
        dead = (rows[1].diff() > 0) & (ms - seen == 0)
        assert bool(dead.any())
        for k in ("n", "mean", "m2"):
            assert torch.equal(my[k][dead], untouched[k][dead]), k


def test_leaf_stats_plain_flags_and_refuses_out_of_range_ids():
    """The plain version raises on an id outside [0, N) (the segment sums'
    length check) after writing ``bad``; the forest step's read of the
    flag names the ids."""
    from repro_torch.core import forest as tfr
    ystats, seen, gl, y, w = leaf_stats_case("zero_weight")
    N = seen.shape[0]
    for planted in (N, -1):
        g = gl.clone()
        g[17] = planted
        bad = torch.zeros(1, dtype=torch.bool)
        with pytest.raises(RuntimeError, match="lengths"):
            leaf_stats.leaf_stats(ystats, seen, g, y, w,
                                  tops.sort_rows(g, N), bad)
        assert bool(bad)
        flags = torch.tensor([False, True])
        with pytest.raises(RuntimeError,
                           match=rf"outside \[0, {N}\): \[{planted}\]"):
            tfr._any_drift(torch.zeros(2, dtype=torch.bool), (flags, g, N))
    flags = torch.zeros(2, dtype=torch.bool)
    assert tfr._any_drift(torch.tensor([False, True]), (flags, gl, N))
    assert not tfr._any_drift(torch.tensor([False, False]), (flags, gl, N))


def model_qo_update(table, x, y, w):
    """``csrc/qo_update.cu``'s order: the rows cut into ``pieces(N)``
    contiguous pieces, each reduced on its own, the partials merged in
    piece order, then into the running table (every bin, empty or not)."""
    C = table["n"].shape[0]
    G, per = qo_update.pieces(x.shape[0])
    with np.errstate(invalid="ignore", over="ignore"):
        ids = _bins(table["radius"], table["origin"], x, C)
        parts = [_piece_stats(ids[g * per:(g + 1) * per],
                              x[g * per:(g + 1) * per],
                              y[g * per:(g + 1) * per],
                              w[g * per:(g + 1) * per], C) for g in range(G)]
        batch, sx = _merge_pieces(parts)
        n, mean, m2 = _chan((table["n"], table["mean"], table["m2"]), batch)
    return n, mean, m2, table["sum_x"] + sx


@pytest.mark.parametrize("N", [0, 1, 1023, 1024, 5000, 270_000, 1_000_000,
                               2 ** 31 - 1])
def test_qo_update_pieces_cover_the_rows(N):
    G, per = qo_update.pieces(N)
    if N == 0:
        assert G == 0
        return
    assert 1 <= G <= qo_update.PIECES and per % 4 == 0
    assert per >= qo_update.MIN_PIECE_ROWS
    assert (G - 1) * per < N <= G * per


@pytest.mark.parametrize("name,C", [("normal", 64), ("normal", 1),
                                    ("one_bin", 64), ("extremes", 64)])
def test_qo_update_piece_order_matches_reference(name, C):
    """The single-table kernel's order (``pieces(N)`` contiguous pieces
    merged in piece order) against ``repro.core.qo.update`` and the Pallas
    body (``ops.qo_update``, interpret), n exact, the rest within 1e-4."""
    from repro.core import qo as jqo
    rng = np.random.default_rng(C + len(name))
    N = 5000                                    # five pieces of 1024 rows
    n = rng.integers(0, 4, C).astype(np.float32)
    table = {"radius": np.float32(0.05), "origin": np.float32(0.1), "n": n,
             "mean": np.where(n > 0, rng.normal(0, 1, C), 0
                              ).astype(np.float32),
             "m2": np.where(n > 1, rng.uniform(0, 1, C), 0
                            ).astype(np.float32),
             "sum_x": (n * rng.normal(0, 1, C)).astype(np.float32)}
    x = rng.normal(0, 1, N).astype(np.float32)
    y = rng.normal(0, 2, N).astype(np.float32)
    w = rng.integers(0, 5, N).astype(np.float32)
    if name == "one_bin":
        x[:] = np.float32(0.3)
    elif name == "extremes":
        x[:7] = [1e10, np.inf, -np.inf, np.nan, 0.0, -0.0, -1e10]
        w[3000:3400] = 0.0
    assert qo_update.pieces(N)[0] == 5
    mine = model_qo_update(table, x, y, w)
    jt = {"radius": jnp.asarray(table["radius"]),
          "origin": jnp.asarray(table["origin"]),
          "sum_x": jnp.asarray(table["sum_x"]),
          "y": {k: jnp.asarray(table[k]) for k in ("n", "mean", "m2")}}
    refs = {"core.qo": jqo.update(jt, x, y, w),
            "interpret": jops.qo_update(jt, x, y, w, interpret=True)}
    for what, ref in refs.items():
        r = [np.asarray(ref["y"][k]) for k in ("n", "mean", "m2")] \
            + [np.asarray(ref["sum_x"])]
        np.testing.assert_array_equal(mine[0], r[0], err_msg=what)
        for k, a, b in zip(("mean", "m2"), mine[1:3], r[1:3]):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg=f"{what}:{k}")
        _assert_sum_x(mine[3], r[3], what)
    if name == "one_bin":
        assert (mine[0] - n).nonzero()[0].tolist() == [
            int(_bins(table["radius"], table["origin"], x[:1], C)[0])]


def query_both(tab_y, sum_x, attempt):
    M, F, C = sum_x.shape
    radius = jnp.ones((M, F), jnp.float32)
    ref = {}
    for b in BACKENDS:
        merit, thr = jops.forest_best_splits(
            {k: jnp.asarray(v) for k, v in tab_y.items()},
            jnp.asarray(sum_x), radius, jnp.zeros_like(radius),
            jnp.asarray(attempt), backend=b, compact=True)
        ref[b] = (np.asarray(merit), np.asarray(thr))
    merit, thr = tops.forest_best_splits(
        {k: torch.tensor(v) for k, v in tab_y.items()}, torch.tensor(sum_x),
        torch.tensor(attempt))
    return ref, (merit.numpy(), thr.numpy())


@pytest.mark.parametrize("M,frac", [(24, 0.25), (63, 1.0)])
def test_query_plain_matches_reference(M, frac):
    rng = np.random.default_rng(M)
    F, C = 3, 32
    tab_y, sum_x = random_tables(rng, M, F, C, occupied=0.4)
    # single-occupied-bin tables and an empty table: no valid boundary
    for name in ("n", "mean", "m2"):
        tab_y[name][1, 0, :] = 0.0
        tab_y[name][2, :, :] = 0.0
    sum_x[1, 0, :] = 0.0
    sum_x[2] = 0.0
    tab_y["n"][1, 0, 7], tab_y["mean"][1, 0, 7], sum_x[1, 0, 7] = 4, 1, 2
    attempt = rng.random(M) < frac
    attempt[:3] = True
    ref, (merit, thr) = query_both(tab_y, sum_x, attempt)
    assert np.isneginf(merit[~attempt]).all()
    assert np.isneginf(merit[1, 0]) and np.isneginf(merit[2]).all()
    for b in BACKENDS:
        rm, rt = ref[b]
        np.testing.assert_array_equal(np.isneginf(merit), np.isneginf(rm),
                                      err_msg=b)
        fin = np.isfinite(rm)
        np.testing.assert_allclose(merit[fin], rm[fin], rtol=TOL, atol=TOL,
                                   err_msg=b)
        np.testing.assert_allclose(thr[fin], rt[fin], rtol=TOL, atol=TOL,
                                   err_msg=b)


# --------------------------------------------------------------------------
# the batched query kernel's order of work, modelled on the CPU
# (csrc/qo_query_batched.cu: a warp a table, Kogge-Stone Chan merges over
# chunks of 32 bins -- 16 for C <= 16 -- carried left to right)
# --------------------------------------------------------------------------

def chan_model(a, b):
    """The kernel's Chan merge of (n, mean, m2) ``a`` (left) and ``b``:
    the TPU kernel's arithmetic with one reciprocal of the merged count,
    an empty side returning the other side unchanged."""
    (an, am, a2), (bn, bm, b2) = a, b
    tn = an + bn
    inv = 1.0 / tn
    delta = bm - am
    mean = (an * am + bn * bm) * inv
    m2 = (a2 + b2) + (delta * delta) * (an * bn) * inv
    b_empty, a_empty = ~(bn > 0), ~(an > 0)
    pick = lambda xa, xb, xm: torch.where(b_empty, xa,
                                          torch.where(a_empty, xb, xm))
    return pick(an, bn, tn), pick(am, bm, mean), pick(a2, b2, m2)


def model_scores(n, mean, m2, sum_x):
    """(R, C) tables -> per-bin (score, cand), (R, C) each, in the
    kernels' order (both queries): per chunk a Kogge-Stone prefix merge,
    the earlier chunks' aggregate merged in on the left, the complement
    by subtraction with one reciprocal of the total's count (and of its
    max with 1) a table; score -inf where the bin has no valid boundary;
    cand at every bin as the plain version defines it (no occupied bin
    after: bin C - 1's prototype)."""
    R, C = n.shape
    W = 16 if C <= 16 else 32
    nch = -(-C // W)
    pad = lambda a: torch.cat([a, torch.zeros(R, nch * W - C)],
                              1).reshape(R, nch, W)
    p = tuple(pad(a) for a in (n, mean, m2))
    lane = torch.arange(W)
    d = 1
    while d < W:
        left = tuple(torch.cat([a[..., :d], a[..., :-d]], -1) for a in p)
        p = tuple(torch.where(lane >= d, m, a)
                  for m, a in zip(chan_model(left, p), p))
        d *= 2
    carry = tuple(torch.zeros(R, 1) for _ in range(3))
    chunks = []
    for ch in range(nch):
        pc = chan_model(carry, tuple(a[:, ch] for a in p))
        chunks.append(pc)
        carry = tuple(a[:, -1:] for a in pc)
    pn, pmean, pm2 = (torch.cat([c[i] for c in chunks], 1) for i in range(3))
    tn, tmean, tm2 = carry

    rn = tn - pn
    rmean = torch.where(rn > 0, (tn * tmean - pn * pmean)
                        / torch.where(rn > 0, rn, 1.0), 0.0)
    delta = pmean - rmean
    inv_tot = 1.0 / torch.where(tn > 0, tn, 1.0)
    inv_ntot = 1.0 / torch.where(tn < 1, 1.0, tn)
    rm2 = (tm2 - pm2) - (delta * delta) * (rn * pn) * inv_tot
    rm2 = torch.where(rn > 0, torch.where(rm2 < 0, 0.0, rm2), 0.0)

    def var(nn, mm):
        dd = nn - 1.0
        return torch.where(dd > 0, mm / torch.where(dd > 0, dd, 1.0), 0.0)

    vr = (var(tn, tm2) - (pn * inv_ntot) * var(pn, pm2)) \
        - (rn * inv_ntot) * var(rn, rm2)

    Cp = nch * W
    occ = pad(n).reshape(R, Cp) > 0
    sx = pad(sum_x).reshape(R, Cp)
    proto = torch.where(occ, sx / torch.where(occ, pad(n).reshape(R, Cp),
                                              1.0), 0.0)
    idx = torch.arange(Cp).expand(R, Cp)
    last = torch.cummax(torch.where(occ, idx, -1), 1).values
    after = torch.flip(torch.cummin(torch.flip(torch.where(occ, idx, Cp),
                                               [1]), 1).values, [1])
    nxt = torch.cat([after[:, 1:], torch.full((R, 1), Cp)], 1)
    ok = (last >= 0) & (nxt < Cp) & (idx < C)
    cand = 0.5 * (torch.gather(proto, 1, last.clamp(min=0))
                  + torch.gather(proto, 1, nxt.clamp(max=C - 1)))
    score = torch.where(ok, vr, float("-inf"))
    return score[:, :C], cand[:, :C]


def model_query(n, mean, m2, sum_x):
    """(R, C) tables -> (merit, thr), (R,) each: the argmax of
    :func:`model_scores` as the kernel picks it, a NaN first, then the
    larger score, then the lower bin."""
    score, cand = model_scores(n, mean, m2, sum_x)
    nan = torch.isnan(score)
    top = torch.where(nan, float("-inf"), score).amax(1, keepdim=True)
    best = torch.where(nan.any(1), torch.argmax(nan.int(), 1),
                       torch.argmax((score == top).int(), 1))[:, None]
    merit = torch.gather(score, 1, best)[:, 0]
    thr = torch.where(merit == float("-inf"), 0.0,
                      torch.gather(cand, 1, best)[:, 0])
    return merit, thr


def model_best(n, mean, m2, sum_x):
    """One (C,) table -> (score, cand, result) as ``csrc/qo_query.cu``
    computes them: :func:`model_scores`' rows, the argmax a NaN first,
    then the larger score, then the lower bin, and ``result = [cand,
    merit, valid]`` at it (merit 0 and valid 0 where not finite)."""
    score, cand = model_scores(n[None], mean[None], m2[None], sum_x[None])
    score, cand = score[0], cand[0]
    nan = torch.isnan(score)
    top = torch.where(nan, float("-inf"), score).amax()
    b = int(torch.argmax(nan.int())) if bool(nan.any()) \
        else int(torch.argmax((score == top).int()))
    valid = bool(torch.isfinite(score[b]))
    result = torch.stack([cand[b], score[b] if valid else torch.tensor(0.0),
                          torch.tensor(float(valid))])
    return score, cand, result


def model_best_splits(tab_y, tab_sum_x, rows):
    """:func:`model_query` over the table rows ``rows`` -> (K, F) each."""
    _, F, C = tab_sum_x.shape
    K = rows.shape[0]
    flat = lambda a: a[rows.long()].reshape(K * F, C).cpu()
    merit, thr = model_query(flat(tab_y["n"]), flat(tab_y["mean"]),
                             flat(tab_y["m2"]), flat(tab_sum_x))
    return merit.reshape(K, F), thr.reshape(K, F)


@pytest.mark.parametrize("C", [1, 2, 16, 33, 64])
def test_query_order_model_matches_reference(C):
    """The kernel's order (modelled) against the TPU kernel in interpret
    mode, the reference's jnp lowering and the port's plain version:
    -inf where they have it, merit and threshold within 1e-4."""
    rng = np.random.default_rng(C)
    M, F = 12, 3
    tab_y, sum_x = random_tables(rng, M, F, C, occupied=0.5)
    for name in ("n", "mean", "m2"):
        tab_y[name][0] = 0.0                     # all bins empty
    sum_x[0] = 0.0
    attempt = np.ones(M, bool)
    ref, (pm, pt) = query_both(tab_y, sum_x, attempt)
    ty = {k: torch.tensor(v) for k, v in tab_y.items()}
    mm, mt = model_best_splits(ty, torch.tensor(sum_x),
                               torch.arange(M, dtype=torch.int32))
    assert torch.isneginf(mm[0]).all() and (mt[0] == 0).all()
    for what, (rm, rt) in list(ref.items()) + [("plain", (pm, pt))]:
        np.testing.assert_array_equal(np.isneginf(mm.numpy()),
                                      np.isneginf(rm), err_msg=what)
        fin = np.isfinite(rm)
        np.testing.assert_allclose(mm.numpy()[fin], rm[fin], rtol=TOL,
                                   atol=TOL, err_msg=what)
        np.testing.assert_allclose(mt.numpy()[fin], rt[fin], rtol=TOL,
                                   atol=TOL, err_msg=what)


def test_query_order_model_argmax_rules():
    """A NaN VR wins (the first NaN), then the first of equal maxima; one
    occupied bin or none gives -inf and 0; an empty operand of the Chan
    merge returns the other one bit for bit, junk statistics and all."""
    C = 40
    n = torch.zeros(4, C)
    mean, m2, sx = torch.zeros(4, C), torch.zeros(4, C), torch.zeros(4, C)
    # row 0: a mirror-symmetric table, bins 3, 10 and 35 (35 in the second
    # chunk) holding (n, mean, M2) = (1, 0, 0), (2, 2, 1), (1, 0, 0): the
    # two boundaries tie exactly
    for b, c, y, v in ((3, 1.0, 0.0, 0.0), (10, 2.0, 2.0, 1.0),
                       (35, 1.0, 0.0, 0.0)):
        n[0, b], mean[0, b], m2[0, b], sx[0, b] = c, y, v, c * b
    # row 1: one occupied bin; row 2: none
    n[1, 7], mean[1, 7], sx[1, 7] = 5.0, 2.0, 3.5
    # row 3: an infinite M2 makes every boundary's VR NaN
    for b in (1, 2, 33):
        n[3, b], mean[3, b], m2[3, b], sx[3, b] = 2.0, float(b), 1.0, b
    m2[3, 2] = float("inf")
    merit, thr = model_query(n, mean, m2, sx)
    score, _ = model_scores(n, mean, m2, sx)
    assert float(score[0, 3]) == float(score[0, 10]) == float(merit[0]) > 0
    assert float(thr[0]) == 0.5 * (3 + 10)          # the first maximum
    assert merit[1:3].isneginf().all() and (thr[1:3] == 0).all()
    assert torch.isnan(merit[3]) and float(thr[3]) == 0.5 * (0.5 + 1.0)
    rng = np.random.default_rng(1)
    a = tuple(torch.tensor(rng.normal(0, 3, 50).astype(np.float32))
              for _ in range(3))
    a = (a[0].abs() + 1,) + a[1:]
    junk = (torch.zeros(50), torch.full((50,), 7.0), torch.full((50,), 9.0))
    for got in (chan_model(a, junk), chan_model(junk, a)):
        assert all(torch.equal(u, v) for u, v in zip(got, a))


def single_table(rng, C, occupied):
    """One (C,) table with ``occupied`` bins of integer weight."""
    n = np.zeros(C, np.float32)
    n[rng.choice(C, occupied, replace=False)] = rng.integers(1, 9, occupied)
    mean = np.where(n > 0, rng.normal(0, 3, C), 0).astype(np.float32)
    m2 = np.where(n > 1, rng.uniform(0, 2, C), 0).astype(np.float32)
    sum_x = (n * (np.arange(C) + rng.uniform(0, 1, C))).astype(np.float32)
    return n, mean, m2, sum_x


@pytest.mark.parametrize("C,occupied", [(1, 1), (16, 0), (16, 1), (33, 20),
                                        (64, 40), (64, 64)])
def test_single_query_order_model_matches_reference(C, occupied):
    """The single-table kernel's order (modelled) against the TPU kernel in
    interpret mode (its (C,) rows and ``ops.qo_best_split``), the
    reference's ``core.qo.best_split`` and the port's plain version: the
    same -inf entries and validity, scores, thresholds and merit within
    1e-4."""
    from repro.core import qo as jqo
    from repro.kernels import ref as jref
    from repro.kernels.qo_query import qo_query_pallas
    n, mean, m2, sum_x = single_table(np.random.default_rng(C + occupied),
                                      C, occupied)
    ms, mc, mr = model_best(*map(torch.tensor, (n, mean, m2, sum_x)))
    table = dict(jqo.init(C, 1.0), sum_x=jnp.asarray(sum_x),
                 y={"n": jnp.asarray(n), "mean": jnp.asarray(mean),
                    "m2": jnp.asarray(m2)})
    rows = np.asarray(qo_query_pallas(jref.pack_table(table)[0],
                                      interpret=True))
    ps, pc, pr = qo_query.best_plain(*map(torch.tensor,
                                          (n, mean, m2, sum_x)))
    for what, (rs, rc) in (("interpret", rows[:2]),
                           ("plain", (ps.numpy(), pc.numpy()))):
        np.testing.assert_array_equal(np.isneginf(ms.numpy()),
                                      np.isneginf(rs), err_msg=what)
        fin = np.isfinite(rs)
        np.testing.assert_allclose(ms.numpy()[fin], rs[fin], rtol=TOL,
                                   atol=TOL, err_msg=what)
        np.testing.assert_allclose(mc.numpy(), rc, rtol=TOL, atol=TOL,
                                   err_msg=what)
    assert float(mr[2]) == float(occupied >= 2)
    for what, ref in (("kernel", jops.qo_best_split(table, interpret=True)),
                      ("core", jqo.best_split(table))):
        assert bool(ref.valid) == bool(mr[2]), what
        np.testing.assert_allclose(
            mr[:2].numpy(), [float(ref.threshold), float(ref.merit)],
            rtol=TOL, atol=TOL, err_msg=what)
    torch.testing.assert_close(mr, pr, rtol=TOL, atol=TOL)


def merge_operands(rng, N, F, C):
    """Two table sets whose cells are, in turn, both occupied, occupied on
    one side only and empty on both (with stray means on empty cells, which
    the merge must ignore)."""
    a_y, a_sx = random_tables(rng, N, F, C, occupied=0.6)
    b_y, b_sx = random_tables(rng, N, F, C, occupied=0.6)
    a_y["n"][0], b_y["n"][0] = 0.0, 0.0          # table 0: both empty
    a_y["n"][1, 0] = 0.0                         # one-sided rows
    b_y["n"][1, 1] = 0.0
    a_y["mean"][0, 0, :3] = 5.0
    for t in (a_y, b_y):
        t["m2"] = np.where(t["n"] > 0, t["m2"], 0).astype(np.float32)
    return a_y, a_sx, b_y, b_sx


@pytest.mark.parametrize("N,C", [(5, 32), (7, 13)])
def test_merge_plain_matches_reference(N, C):
    """``forest_merge`` (the plain version on the CPU) against the
    reference's op on both paths: n exact, the rest within 1e-4."""
    rng = np.random.default_rng(N * C)
    F = 3
    a_y, a_sx, b_y, b_sx = merge_operands(rng, N, F, C)
    py, psx = tops.forest_merge(
        {k: torch.tensor(v) for k, v in a_y.items()}, torch.tensor(a_sx),
        {k: torch.tensor(v) for k, v in b_y.items()}, torch.tensor(b_sx))
    for b in BACKENDS:
        ry, rsx = jops.forest_merge(
            {k: jnp.asarray(v) for k, v in a_y.items()}, jnp.asarray(a_sx),
            {k: jnp.asarray(v) for k, v in b_y.items()}, jnp.asarray(b_sx),
            backend=b)
        np.testing.assert_array_equal(py["n"].numpy(), np.asarray(ry["n"]),
                                      err_msg=b)
        for k in ("mean", "m2"):
            np.testing.assert_allclose(py[k].numpy(), np.asarray(ry[k]),
                                       rtol=TOL, atol=TOL, err_msg=f"{b}:{k}")
        np.testing.assert_allclose(psx.numpy(), np.asarray(rsx), rtol=TOL,
                                   atol=TOL, err_msg=b)
    # empty on both sides: the merge identity, exactly
    for k in ("n", "mean", "m2"):
        assert not py[k][0].any()
    # one-sided cells take the occupied side's statistics
    one = a_y["n"][1, 0] == 0
    np.testing.assert_allclose(py["mean"][1, 0].numpy()[one],
                               b_y["mean"][1, 0][one], rtol=1e-6)
    np.testing.assert_allclose(py["m2"][1, 0].numpy()[one],
                               b_y["m2"][1, 0][one], rtol=1e-6)


def test_query_all_quiet_queries_nothing(monkeypatch):
    """K = 0: no table is queried (on the card: no launch) and every merit
    is -inf, as the reference's concrete dispatch returns."""
    def boom(*a, **k):
        raise AssertionError("queried with K = 0")
    monkeypatch.setattr(qo_query_batched, "best_splits", boom)
    tab_y, sum_x = random_tables(np.random.default_rng(0), 8, 2, 16)
    merit, thr = tops.forest_best_splits(
        {k: torch.tensor(v) for k, v in tab_y.items()}, torch.tensor(sum_x),
        torch.zeros(8, dtype=torch.bool))
    assert torch.isneginf(merit).all() and (thr == 0).all()


#: Blocking runtime calls, as the benchmark's trace reader counts them.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _flat(tree, prefix=""):
    """``{path: CPU tensor}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.cpu()}


def friedman(rng, B, F):
    """Friedman #1 over F uniform features, noise sd 1."""
    X = rng.random((B, F)).astype(np.float32)
    y = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - 0.5) ** 2
         + 10 * X[:, 3] + 5 * X[:, 4] + rng.normal(0, 1, B))
    return X, y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _grown_forest(dev):
    """The stable cell's forest (River's ARF defaults on the QO observer:
    T = 10, M = 1023, F = 16, C = 64, 4,096-row batches) after 64 batches
    of Friedman #1, and a next batch."""
    from repro_torch.core import forest as tfr
    from repro_torch.core import hoeffding as tht
    tree = tht.HTRConfig(n_features=16, max_nodes=1023, n_bins=64,
                         grace_period=50, delta=0.01, tau=0.05, max_depth=12,
                         r0=0.05, sigma_k=2.0)
    cfg = tfr.ForestConfig(tree=tree, n_trees=10, lam=6.0, subspace=0.25,
                           vote="mean")
    rng = np.random.default_rng(64)
    state = tfr.init_forest(cfg, 64, device=dev)
    for _ in range(64):
        state, _ = tfr.update(cfg, state, *friedman(rng, 4096, 16),
                              device=dev)
    X, y = friedman(rng, 4096, 16)
    return cfg, state, (torch.tensor(X, device=dev),
                        torch.tensor(y, device=dev))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """Each CUDA kernel against its plain version on the same card."""

    @pytest.mark.parametrize("T,M,F,B,extra", [
        (1, 63, 5, 1, 0), (16, 1023, 16, 300, 5), (16, 63, 5, 4096, 0),
        (2, 16383, 5, 300, 3), (3, 127, 70, 257, 0),
        (2, 16383, 70, 300, 0)])
    def test_route_kernel(self, card, T, M, F, B, extra):
        """The kernel on the (T, M) arrays against ``route_plain``, ids
        exact, one launch: one tree and sixteen (one of them a bare root),
        one row and row counts off the 256-row tile, NaN and +-inf rows, a
        bound ``extra`` plies past the deepest leaf; M = 16,383 past the
        block's shared memory (the records read from global memory), with
        narrow and wide rows (F = 5, 70)."""
        rng = np.random.default_rng(T * M + B)
        splits = np.minimum(rng.integers(0, M // 2, T), 3000)
        splits[0] = 0 if T > 1 else M // 2
        feature, thr, child, is_leaf, depth = random_trees(rng, T, M, F,
                                                           splits)
        trees = [torch.tensor(a, device=card)
                 for a in (feature, thr, child, is_leaf)]
        X = torch.tensor(rows_with_extremes(rng, B, F), device=card)
        plies = int(depth.max()) + extra
        before = _build.LAUNCHES["qo_route"]
        k = qo_route.route_kernel(*trees, X, plies)
        assert _build.LAUNCHES["qo_route"] == before + 1
        p = qo_route.route_plain(*trees, X, plies)
        assert k.dtype == torch.int32 and k.shape == (T, B)
        assert torch.equal(k, p)
        if T > 1:
            assert bool((k[0] == 0).all())      # the bare root

    @staticmethod
    def _absorb_on_card(card, fn, tab_y, sum_x, args, **kw):
        ty = {k: torch.tensor(v, device=card) for k, v in tab_y.items()}
        tsx = torch.tensor(sum_x, device=card)
        fn(ty, tsx, *args, **kw)
        torch.cuda.synchronize()
        return ty, tsx

    def _absorb_holds(self, card, tab_y, sum_x, args, rows=None):
        """Kernel vs plain version (n exact, the rest within 1e-4), one
        launch a call, and a bitwise rerun.  Returns the kernel's tables."""
        before = _build.LAUNCHES["qo_update_leaves"]
        ky, ksx = self._absorb_on_card(card, qo_update_leaves.absorb_kernel,
                                       tab_y, sum_x, args, rows=rows)
        assert _build.LAUNCHES["qo_update_leaves"] == before + 1
        py, psx = self._absorb_on_card(card, qo_update_leaves.absorb_plain,
                                       tab_y, sum_x, args)
        assert torch.equal(ky["n"], py["n"])
        for k in ("mean", "m2"):
            torch.testing.assert_close(ky[k], py[k], rtol=TOL, atol=TOL,
                                       equal_nan=True)
        torch.testing.assert_close(ksx, psx, rtol=TOL, atol=TOL,
                                   equal_nan=True)
        again_y, again_sx = self._absorb_on_card(
            card, qo_update_leaves.absorb_kernel, tab_y, sum_x, args,
            rows=rows)
        assert _build.LAUNCHES["qo_update_leaves"] == before + 2
        assert all(torch.equal(ky[k], again_y[k]) for k in ky)
        assert torch.equal(ksx.nan_to_num(), again_sx.nan_to_num())
        return ky, ksx

    def test_absorb_kernel(self, card):
        rng = np.random.default_rng(2)
        T, M, F, C, B = 2, 31, 3, 48, 257
        tab_y, sum_x = random_tables(rng, T * M, F, C)
        radius = rng.uniform(0.05, 0.4, (T * M, F)).astype(np.float32)
        origin = rng.normal(0, 0.5, (T * M, F)).astype(np.float32)
        leaf = rng.integers(0, T * M, T * B).astype(np.int32)
        args = [torch.tensor(a, device=card) for a in (
            radius, origin, leaf, rng.normal(0, 1, (B, F)).astype(np.float32),
            rng.normal(0, 2, B).astype(np.float32),
            rng.poisson(3.0, T * B).astype(np.float32))]
        ky, _ = self._absorb_holds(card, tab_y, sum_x, args)
        # the main path passes the step's own sort: the same tables
        rows = qo_update_leaves.sort_rows(args[2], T * M)
        ry, _ = self._absorb_holds(card, tab_y, sum_x, args, rows=rows)
        assert all(torch.equal(ky[k], ry[k]) for k in ky)

    @pytest.mark.parametrize("name", ["whole_batch", "one_bin", "extremes"])
    def test_absorb_kernel_pieces(self, card, name):
        """Leaves of several pieces (a root holding a tree's batch, runs of
        exactly PIECE_ROWS and PIECE_ROWS + 1 rows), on F = 3 (scalar x
        loads) and on F = 16, C = 64 (16-byte loads, the main path's
        width)."""
        tab_y, sum_x, radius, origin, leaf, X, y, w, T, R = \
            skewed_absorb_case(name)
        args = [torch.tensor(a, device=card)
                for a in (radius, origin, leaf, X, y, w)]
        self._absorb_holds(card, tab_y, sum_x, args)
        rng = np.random.default_rng(3)
        N, F, C, B = T * 7, 16, 64, X.shape[0]
        tab_y, sum_x = random_tables(rng, N, F, C)
        args = [torch.tensor(a, device=card) for a in (
            rng.uniform(0.1, 0.5, (N, F)).astype(np.float32),
            rng.normal(0, 0.3, (N, F)).astype(np.float32), leaf,
            rng.normal(0, 1, (B, F)).astype(np.float32), y, w)]
        self._absorb_holds(card, tab_y, sum_x, args)

    @pytest.mark.parametrize("F,C", [(16, 1024), (5, 13)])
    def test_absorb_kernel_shapes(self, card, F, C):
        """F*C past one block's shared memory (features in groups, 12 of 16
        a block) and F, C off the 16-byte paths (scalar x and table
        accesses), with leaves of one and of several pieces."""
        rng = np.random.default_rng(F * C)
        N, B = 6, 300
        tab_y, sum_x = random_tables(rng, N, F, C)
        leaf = np.concatenate([np.zeros(B, np.int32),
                               rng.integers(1, N, B).astype(np.int32)])
        args = [torch.tensor(a, device=card) for a in (
            rng.uniform(0.05, 0.4, (N, F)).astype(np.float32),
            rng.normal(0, 0.5, (N, F)).astype(np.float32), leaf,
            rng.normal(0, 1, (B, F)).astype(np.float32),
            rng.normal(0, 2, B).astype(np.float32),
            rng.poisson(3.0, 2 * B).astype(np.float32))]
        self._absorb_holds(card, tab_y, sum_x, args)

    def test_out_of_range_leaf_ids_raise(self, card):
        """Without the step's sort the wrapper checks the ids itself; on
        the main path the segment statistics refuse them (the runs cover
        fewer rows than there are) with no host read of their own."""
        from repro_torch.core import hoeffding as tht
        N, F, C, B = 6, 2, 8, 40
        tab_y = {k: torch.zeros((N, F, C), device=card)
                 for k in ("n", "mean", "m2")}
        leaf = torch.arange(B, dtype=torch.int32, device=card) % N
        leaf[5] = N
        ones = torch.ones(B, device=card)
        with pytest.raises(ValueError, match="outside"):
            qo_update_leaves.absorb_kernel(
                tab_y, torch.zeros((N, F, C), device=card),
                torch.ones((N, F), device=card),
                torch.zeros((N, F), device=card), leaf,
                torch.zeros((B, F), device=card), ones, ones)
        with pytest.raises(RuntimeError, match="lengths"):
            tht.segment_stats(ones, leaf, N, ones)

    @staticmethod
    def _leaf_stats_on_card(card, ystats, seen, gl, y, w, rows, fn=None):
        """One call on copies on the card: (ystats, seen, bad)."""
        on = lambda t: t.to(card).clone()
        bad = torch.ones(1, dtype=torch.bool, device=card)
        ky = {k: on(v) for k, v in ystats.items()}
        out = (fn or leaf_stats.leaf_stats)(ky, on(seen), gl.to(card),
                                            on(y), on(w), rows, bad)
        torch.cuda.synchronize()
        return out[0], out[1], bad

    @pytest.mark.parametrize("name", LEAF_STATS_CASES)
    def test_leaf_stats_kernel(self, card, name):
        """Bitwise equal to the float32 model of its order; against the
        plain version n and seen exact, mean and M2 within 1e-4 (the
        order's test on the CPU says why); in place, one launch a call, no
        id flagged, and a rerun gives the same bits."""
        ystats, seen, gl, y, w = leaf_stats_case(name)
        rows = tops.sort_rows(gl.to(card), seen.shape[0])
        bits = lambda t: t.cpu().view(torch.int32)
        before = _build.LAUNCHES["leaf_stats"]
        ky, ks, bad = self._leaf_stats_on_card(card, ystats, seen, gl, y, w,
                                               rows)
        assert _build.LAUNCHES["leaf_stats"] == before + 1
        assert not bool(bad)
        my, ms = model_leaf_stats(ystats, seen, rows, y, w)
        for k in ("n", "mean", "m2"):
            assert torch.equal(bits(ky[k]), bits(my[k])), k
        assert torch.equal(bits(ks), bits(ms))
        py, ps, _ = self._leaf_stats_on_card(
            card, ystats, seen, gl, y, w, rows, leaf_stats.leaf_stats_plain)
        assert torch.equal(ky["n"], py["n"]) and torch.equal(ks, ps)
        for k in ("mean", "m2"):
            torch.testing.assert_close(ky[k], py[k], rtol=TOL, atol=TOL)
        again_y, again_s, _ = self._leaf_stats_on_card(card, ystats, seen, gl,
                                                       y, w, rows)
        assert _build.LAUNCHES["leaf_stats"] == before + 2
        for k in ("n", "mean", "m2"):
            assert torch.equal(bits(again_y[k]), bits(ky[k])), k
        assert torch.equal(bits(again_s), bits(ks))
        # in place: the kernel returns the tensors it was given
        t = {k: v.to(card) for k, v in ystats.items()}
        s_ = seen.to(card)
        out = leaf_stats.leaf_stats_kernel(t, s_, y.to(card), w.to(card),
                                           rows, bad)
        assert out[0] is t and out[1] is s_
        assert torch.equal(bits(t["mean"]), bits(ky["mean"]))

    def test_leaf_stats_kernel_flags_out_of_range_ids(self, card):
        """An id outside [0, N) lies in no run: the kernel sets the flag
        (and the in-range entries still merge)."""
        ystats, seen, gl, y, w = leaf_stats_case("zero_weight")
        N = seen.shape[0]
        for planted in (N, -1):
            g = gl.clone()
            g[17] = planted
            rows = tops.sort_rows(g.to(card), N)
            _, _, bad = self._leaf_stats_on_card(card, ystats, seen, g, y, w,
                                                 rows)
            assert bool(bad), planted

    def test_forest_update_leaf_stats(self, card, monkeypatch):
        """One ``forest.update`` at the stable cell's shape (T = 10, M =
        1023, F = 16, C = 64, B = 4,096, trees grown over 64 batches)
        against the same step on today's composition (the plain version
        on the card): integer, boolean and table arrays and the step's
        errors bitwise, the target statistics n exact and mean, M2 within
        1e-4; two runs from one state agree bit for bit."""
        from repro_torch.core import forest as tfr
        cfg, state, (X, y) = _grown_forest(card)
        runs = [tfr.update(cfg, _clone(state), X, y, device=card)
                for _ in range(2)]
        monkeypatch.setattr(tfr.kleaf, "leaf_stats",
                            leaf_stats.leaf_stats_plain)
        plain = tfr.update(cfg, _clone(state), X, y, device=card)
        flat = [_flat({"state": st, "aux": aux}) for st, aux in
                runs + [plain]]
        assert flat[0].keys() == flat[2].keys()
        for key, a in flat[0].items():
            assert torch.equal(a, flat[1][key]), key
            b = flat[2][key]
            if key.startswith(("state/trees/ystats/mean",
                               "state/trees/ystats/m2")):
                torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
            else:
                assert torch.equal(a, b), key

    def test_forest_update_out_of_range_leaf_id_raises(self, card,
                                                       monkeypatch):
        """A folded leaf id planted outside [0, T*M) in the step's sort
        raises a RuntimeError naming it, in that same ``update``."""
        from repro_torch.core import forest as tfr
        cfg, state, (X, y) = _grown_forest(card)
        T, M = cfg.n_trees, cfg.tree.max_nodes
        orig = tfr._fused_route_sort

        def planted(cfg_, trees, X_):
            gl, leaf, _ = orig(cfg_, trees, X_)
            gl = gl.clone()
            gl[5] = T * M
            return gl, leaf, tops.sort_rows(gl, T * M)
        monkeypatch.setattr(tfr, "_fused_route_sort", planted)
        with pytest.raises(RuntimeError,
                           match=rf"outside \[0, {T * M}\): \[{T * M}\]"):
            tfr.update(cfg, _clone(state), X, y, device=card)

    def test_forest_stats_has_no_sync_under_profile(self, card, tmp_path):
        """Under ``perf.profile.trace`` the ``forest.stats`` spans hold no
        blocking runtime call (the step's syncs sit in other stages, the
        drift read among them) and ``forest.leaf_stats`` equals
        ``forest.steps``."""
        import glob
        import json
        from repro_torch.core import forest as tfr
        from repro_torch.perf import profile
        cfg, state, (X, y) = _grown_forest(card)
        state = _clone(state)
        with profile.trace(str(tmp_path)):
            for _ in range(3):
                state, _ = tfr.update(cfg, state, X, y, device=card)
        counts = json.load(open(glob.glob(str(tmp_path / "counters_*"))[0]))
        assert counts["forest.leaf_stats"] == counts["forest.steps"] == 3
        events = json.load(open(glob.glob(str(tmp_path / "trace_*"))[0]))[
            "traceEvents"]
        spans_of = lambda name: [(e["ts"], e["ts"] + e["dur"])
                                 for e in events if e.get("name") == name
                                 and e.get("cat") == "user_annotation"]
        syncs = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                 and e.get("name") in SYNC_CALLS]
        within = lambda ivs: sum(s <= t <= e for t in syncs for s, e in ivs)
        assert len(spans_of("forest.stats")) == 6
        assert within(spans_of("forest.drift")) >= 3
        assert within(spans_of("forest.stats")) == 0

    def _query_holds(self, card, tab_y, sum_x, rows):
        """Kernel bitwise equal to the float32 model of its order, and
        against the plain version the same -inf and NaN entries, merit and
        threshold within 1e-4; one launch a call, a bitwise rerun.
        Returns (merit, thr) of the kernel."""
        ty = {k: torch.tensor(v, device=card) for k, v in tab_y.items()}
        tsx = torch.tensor(sum_x, device=card)
        rows = torch.tensor(rows, dtype=torch.int32, device=card)
        before = _build.LAUNCHES["qo_query_batched"]
        km, kt = qo_query_batched.best_splits_kernel(ty, tsx, rows)
        assert _build.LAUNCHES["qo_query_batched"] == before + 1
        mm, mt = model_best_splits(ty, tsx, rows)
        torch.testing.assert_close(km.cpu(), mm, rtol=0, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(kt.cpu(), mt, rtol=0, atol=0,
                                   equal_nan=True)
        pm, pt = qo_query_batched.best_splits_plain(ty, tsx, rows)
        assert torch.equal(torch.isneginf(km), torch.isneginf(pm))
        assert torch.equal(torch.isnan(km), torch.isnan(pm))
        fin = torch.isfinite(pm)
        torch.testing.assert_close(km[fin], pm[fin], rtol=TOL, atol=TOL)
        torch.testing.assert_close(kt[fin], pt[fin], rtol=TOL, atol=TOL)
        again = qo_query_batched.best_splits_kernel(ty, tsx, rows)
        assert torch.equal(km.nan_to_num(), again[0].nan_to_num())
        assert torch.equal(kt.nan_to_num(), again[1].nan_to_num())
        return km, kt

    @pytest.mark.parametrize("C", [1, 16, 32, 64, 100, 1024])
    def test_query_kernel(self, card, C):
        """Random tables (one and two tables a warp, one and several
        chunks, C off the chunk width), with a table of one occupied bin,
        an empty one, one whose VR is NaN, and repeated rows."""
        rng = np.random.default_rng(C)
        N, F = 40, 3
        tab_y, sum_x = random_tables(rng, N, F, C, occupied=0.4)
        for name in ("n", "mean", "m2"):
            tab_y[name][0] = 0.0
            tab_y[name][1, 0] = 0.0
        sum_x[0], sum_x[1, 0] = 0.0, 0.0
        tab_y["n"][1, 0, C - 1], tab_y["mean"][1, 0, C - 1] = 3.0, 1.0
        sum_x[1, 0, C - 1] = 1.5
        if C > 2:
            tab_y["n"][2, 1, :3] = 2.0
            tab_y["m2"][2, 1, 1] = np.inf
        rows = np.concatenate([[0, 1, 2, 2], rng.choice(N, 17,
                                                        replace=False)])
        km, kt = self._query_holds(card, tab_y, sum_x, rows)
        assert torch.isneginf(km[0]).all() and (kt[0] == 0).all()
        assert torch.isneginf(km[1, 0]) and kt[1, 0] == 0
        if C > 2:
            assert torch.isnan(km[2, 1])
        assert torch.equal(km[2].nan_to_num(), km[3].nan_to_num())
        N_ = tab_y["n"].shape[0]
        before = _build.LAUNCHES["qo_query_batched"]
        merit, _ = tops.forest_best_splits(
            {k: torch.tensor(v, device=card) for k, v in tab_y.items()},
            torch.tensor(sum_x, device=card),
            torch.zeros(N_, dtype=torch.bool, device=card))
        assert torch.isneginf(merit).all()          # K = 0: no launch
        assert _build.LAUNCHES["qo_query_batched"] == before

    @staticmethod
    def _fragile_rows(n_sorted, K):
        """Rows where the kernel's ids may differ from the plain version's
        with non-integer weights: a centroid whose scaled midpoint lies
        within a few ulps of an inner bucket edge (the kernel's scan sums
        the cumulative weights in another order)."""
        c64 = torch.cumsum(n_sorted.double(), -1)
        x = (c64 - 0.5 * n_sorted.double()) * (K / c64[..., -1:])
        m = torch.round(x)
        return (((x - m).abs() <= 1e-6 * torch.clamp(x.abs(), min=1.0))
                & (m >= 1) & (m <= K - 1)).any(-1)

    @pytest.mark.parametrize("J,K,integer", [
        (2, 2, True), (32, 16, True), (33, 16, True), (64, 32, True),
        (512, 256, True), (48, 12, True), (32, 16, False)])
    def test_sketch_compact_kernel(self, card, J, K, integer):
        """The fused kernel vs ``compact_plain`` on unsorted centroids with
        tied, +-0.0, NaN and empty prototypes and all-empty rows: n exact
        (integer weights), the rest within 1e-4, one launch a call, a
        bitwise rerun; as one plane set and as two (the merge).  With
        non-integer weights the rows whose ids sit on an integer edge are
        left out (the kernel's cumulative weights sum in another order)."""
        rng = np.random.default_rng(J * K)
        R = 300
        n = (rng.integers(0, 6, (R, J)) * (rng.random((R, J)) < 0.8)
             ).astype(np.float32)
        if not integer:
            n = (n * rng.uniform(0.1, 2.0, (R, J))).astype(np.float32)
        n[:5] = 0.0                                  # all-empty rows
        proto = rng.choice(np.float32([-1.0, -0.0, 0.0, 0.5, 2.0]), (R, J))
        proto = np.where(rng.random((R, J)) < 0.5, proto,
                         rng.normal(0, 1, (R, J))).astype(np.float32)
        sum_x = (n * proto).astype(np.float32)
        sum_x[5::37, 0] = np.nan
        planes = [torch.tensor(a, device=card) for a in (
            n, rng.normal(0, 2, (R, J)).astype(np.float32),
            (n * rng.uniform(0, 1, (R, J))).astype(np.float32), sum_x)]
        before = _build.LAUNCHES["sketch_compact"]
        k = sketch_compact.compact_kernel(planes, K)
        assert _build.LAUNCHES["sketch_compact"] == before + 1
        p = sketch_compact.compact_plain(planes, K)
        keep = torch.ones(R, dtype=torch.bool, device=card)
        if not integer:
            srt = sketch_compact.sort_planes(*planes)[0]
            keep = ~self._fragile_rows(srt, K)
            print(f"J={J} K={K}: {int((~keep).sum())} of {R} rows on an "
                  f"integer edge left out")
            assert int(keep.sum()) >= R // 2
        if integer:
            assert torch.equal(k[0][keep], p[0][keep])
        for a, b in zip(k, p):
            torch.testing.assert_close(a[keep], b[keep], rtol=TOL, atol=TOL,
                                       equal_nan=True)
        again = sketch_compact.compact_kernel(planes, K)
        assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
                   for a, b in zip(k, again))
        half = J // 2
        if half:
            two = sketch_compact.compact_kernel(
                [a[:, :half].contiguous() for a in planes], K,
                [a[:, half:].contiguous() for a in planes])
            assert _build.LAUNCHES["sketch_compact"] == before + 3
            assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
                       for a, b in zip(k, two))
        assert torch.equal(k[0][:5], torch.zeros_like(k[0][:5]))

    @staticmethod
    def _qo_update_holds(card, C, x, y, w, rng):
        """Kernel vs plain absorb of one table: n exact, the rest within
        1e-4, one launch a call, a bitwise rerun."""
        n = rng.integers(0, 4, C).astype(np.float32)
        table = [torch.tensor(a, device=card) for a in (
            n, np.where(n > 0, rng.normal(0, 1, C), 0).astype(np.float32),
            np.where(n > 1, rng.uniform(0, 1, C), 0).astype(np.float32),
            (n * rng.normal(0, 1, C)).astype(np.float32))]
        args = [torch.tensor(np.float32(0.02), device=card),
                torch.tensor(np.float32(0.1), device=card)] + [
            torch.tensor(a, device=card) for a in (x, y, w)]
        before = _build.LAUNCHES["qo_update"]
        k = qo_update.update_kernel(*table, *args)
        assert _build.LAUNCHES["qo_update"] == before + 1
        p = qo_update.update_plain(*table, *args)
        assert torch.equal(k[0], p[0])
        for a, b in zip(k[1:], p[1:]):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL,
                                       equal_nan=True)
        again = qo_update.update_kernel(*table, *args)
        assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                   for a, b in zip(k, again))
        return k[0] - table[0]

    def test_qo_update_kernel(self, card):
        rng = np.random.default_rng(5)
        C, N = 256, 20000
        x = rng.normal(0, 1, N).astype(np.float32)
        x[:6] = [1e10, np.inf, -np.inf, np.nan, 0.0, -0.0]
        self._qo_update_holds(card, C, x, rng.normal(0, 2, N).astype(
            np.float32), rng.integers(0, 5, N).astype(np.float32), rng)

    @pytest.mark.parametrize("C,N,one_bin", [
        (1, 5000, False), (1024, 300_001, True),
        (qo_update.MAX_BINS, 200_000, False)])
    def test_qo_update_kernel_shapes(self, card, C, N, one_bin):
        """C = 1; C = 1024 with every row in one bin (x constant, many
        pieces, 300,001 rows: a ragged last piece); C = MAX_BINS, whose
        bins are tiled over the grid (x spread over the whole table)."""
        rng = np.random.default_rng(C)
        if one_bin:
            x = np.full(N, 0.5, np.float32)
        else:
            x = rng.uniform(-0.02 * C / 2, 0.02 * C / 2, N).astype(np.float32)
        w = rng.integers(0, 3, N).astype(np.float32)
        added = self._qo_update_holds(
            card, C, x, rng.normal(0, 2, N).astype(np.float32), w, rng)
        assert float(added.sum()) == float(w.sum())
        if one_bin:
            assert added.nonzero().numel() == 1

    def test_qo_merge_kernel(self, card):
        """Bitwise equal to the plain version on the card: the float4 path
        (N*F*C % 4 == 0), the scalar tail and an unaligned operand."""
        rng = np.random.default_rng(7)
        for N, F, C in ((40, 3, 32), (9, 5, 13)):
            a_y, a_sx, b_y, b_sx = merge_operands(rng, N, F, C)
            planes = [torch.tensor(v, device=card) for v in (
                a_y["n"], a_y["mean"], a_y["m2"], a_sx,
                b_y["n"], b_y["mean"], b_y["m2"], b_sx)]
            before = _build.LAUNCHES["qo_merge"]
            k = qo_merge.merge_kernel(*planes)
            assert _build.LAUNCHES["qo_merge"] == before + 1
            p = qo_merge.merge_plain(*planes)
            assert all(torch.equal(u, v) for u, v in zip(k, p))
            # an operand 4 bytes off a 16-byte boundary: the scalar path
            shifted = [torch.cat([torch.zeros(1, device=card),
                                  t.reshape(-1)])[1:].reshape(t.shape)
                       for t in planes]
            k = qo_merge.merge_kernel(*shifted)
            assert all(torch.equal(u, v) for u, v in zip(k, p))

    @staticmethod
    def _qo_query_holds(card, n, mean, m2, sum_x):
        """The kernel on one table: bitwise equal to :func:`model_best`,
        against ``best_plain`` the same -inf and NaN entries and validity,
        scores, thresholds and merit within 1e-4; one launch a call, a
        bitwise rerun.  Returns the kernel's (score, cand, result)."""
        planes = [torch.tensor(a, device=card) for a in (n, mean, m2, sum_x)]
        before = _build.LAUNCHES["qo_query"]
        k = qo_query.best_kernel(*planes)
        assert _build.LAUNCHES["qo_query"] == before + 1
        for a, b in zip(k, model_best(*(a.cpu() for a in planes))):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0,
                                       equal_nan=True)
        (ks, kc, kr), (ps, pc, pr) = k, qo_query.best_plain(*planes)
        assert torch.equal(torch.isneginf(ks), torch.isneginf(ps))
        assert torch.equal(torch.isnan(ks), torch.isnan(ps))
        fin = torch.isfinite(ps)
        torch.testing.assert_close(ks[fin], ps[fin], rtol=TOL, atol=TOL)
        torch.testing.assert_close(kc, pc, rtol=TOL, atol=TOL,
                                   equal_nan=True)
        torch.testing.assert_close(kr, pr, rtol=TOL, atol=TOL,
                                   equal_nan=True)
        again = qo_query.best_kernel(*planes)
        assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
                   for a, b in zip(k, again))
        return k

    def test_qo_query_kernel(self, card):
        rng = np.random.default_rng(6)
        for C, occupied in ((1024, 300), (96, 1), (3000, 2000), (64, 0)):
            n = np.zeros(C, np.float32)
            n[rng.choice(C, occupied, replace=False)] = rng.integers(
                1, 9, occupied)
            planes = (
                n, np.where(n > 0, rng.normal(0, 3, C), 0).astype(np.float32),
                np.where(n > 1, rng.uniform(0, 2, C), 0).astype(np.float32),
                (n * (np.arange(C) + rng.uniform(0, 1, C))).astype(
                    np.float32))
            _, _, kr = self._qo_query_holds(card, *planes)
            assert float(kr[2]) == float(occupied >= 2)

    @pytest.mark.parametrize("C", [1, 16, 31, 32, 33, 1024, 3000,
                                   qo_query.MAX_BINS])
    def test_qo_query_kernel_shapes(self, card, C):
        """One and several warps, chunks off the 32-bin width, past 1,024
        bins (warps loop over their chunks) up to MAX_BINS: a table with
        half its bins occupied, an empty one, one with a single occupied
        bin (the last), and one with a NaN mean (every score after it
        NaN, the argmax the first NaN)."""
        rng = np.random.default_rng(C)
        n, mean, m2, sum_x = single_table(rng, C, (C + 1) // 2)
        _, _, kr = self._qo_query_holds(card, n, mean, m2, sum_x)
        assert float(kr[2]) == float((C + 1) // 2 >= 2)
        zero = np.zeros(C, np.float32)
        _, _, kr = self._qo_query_holds(card, zero, zero, zero, zero)
        assert float(kr[2]) == 0.0 and float(kr[1]) == 0.0
        one = zero.copy()
        one[-1] = 3.0
        _, _, kr = self._qo_query_holds(card, one, one, zero, one * 0.5)
        assert float(kr[2]) == 0.0
        if C >= 3:
            occ = np.flatnonzero(n)
            mean = mean.copy()
            mean[occ[len(occ) // 2]] = np.nan
            ks, _, kr = self._qo_query_holds(card, n, mean, m2, sum_x)
            assert bool(torch.isnan(ks).any()) and float(kr[2]) == 0.0
