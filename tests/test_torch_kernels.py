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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.core import sketch as tsk
from repro_torch.kernels import (qo_merge, qo_query, qo_query_batched,
                                 qo_route, qo_update, qo_update_leaves,
                                 sketch_compact)

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """Each CUDA kernel against its plain version on the same card."""

    def test_route_kernel(self, card):
        rng = np.random.default_rng(1)
        T, M, F, B = 4, 63, 5, 300
        feature, thr, child, is_leaf, depth = random_trees(rng, T, M, F, 30)
        X = torch.tensor(rows_with_extremes(rng, B, F), device=card)
        folded = qo_route.fold_route_tables(
            *(torch.tensor(a, device=card)
              for a in (feature, thr, child, is_leaf)))
        before = _build.LAUNCHES["qo_route"]
        k = qo_route.route_kernel(*folded, X, T, M, int(depth.max()))
        p = qo_route.route_plain(*folded, X, T, M, int(depth.max()))
        assert torch.equal(k, p)
        assert _build.LAUNCHES["qo_route"] == before + 1

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

    def test_query_kernel(self, card):
        rng = np.random.default_rng(3)
        N, F, C = 40, 3, 32
        tab_y, sum_x = random_tables(rng, N, F, C, occupied=0.4)
        ty = {k: torch.tensor(v, device=card) for k, v in tab_y.items()}
        tsx = torch.tensor(sum_x, device=card)
        rows = torch.tensor(rng.choice(N, 17, replace=False).astype(np.int32),
                            device=card)
        km, kt = qo_query_batched.best_splits_kernel(ty, tsx, rows)
        pm, pt = qo_query_batched.best_splits_plain(ty, tsx, rows)
        assert torch.equal(torch.isneginf(km), torch.isneginf(pm))
        fin = torch.isfinite(pm)
        torch.testing.assert_close(km[fin], pm[fin], rtol=TOL, atol=TOL)
        torch.testing.assert_close(kt[fin], pt[fin], rtol=TOL, atol=TOL)
        before = _build.LAUNCHES["qo_query_batched"]
        merit, _ = tops.forest_best_splits(
            ty, tsx, torch.zeros(N, dtype=torch.bool, device=card))
        assert torch.isneginf(merit).all()
        assert _build.LAUNCHES["qo_query_batched"] == before

    def test_sketch_compact_kernel(self, card):
        rng = np.random.default_rng(4)
        for J, K in ((32, 16), (80, 40)):
            n = (rng.integers(0, 6, (300, J)) * (rng.random((300, J)) < 0.8)
                 ).astype(np.float32)
            planes = [torch.tensor(a, device=card) for a in (
                n, rng.normal(0, 2, (300, J)).astype(np.float32),
                (n * rng.uniform(0, 1, (300, J))).astype(np.float32),
                (n * rng.normal(0, 1, (300, J))).astype(np.float32))]
            planes = [a.contiguous() for a in tsk.sort_planes(*planes)]
            bucket = tsk._bucket_ids(planes[0], K)
            # row 0 with unsorted ids: the kernel's centroid-by-centroid path
            bucket[0] = torch.flip(bucket[0], [0])
            before = _build.LAUNCHES["sketch_compact"]
            k = sketch_compact.bucket_reduce_kernel(*planes, bucket, K)
            p = sketch_compact.bucket_reduce_plain(*planes, bucket, K)
            assert _build.LAUNCHES["sketch_compact"] == before + 1
            assert torch.equal(k[0], p[0])
            for a, b in zip(k[1:], p[1:]):
                torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
            again = sketch_compact.bucket_reduce_kernel(*planes, bucket, K)
            assert all(torch.equal(a, b) for a, b in zip(k, again))

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

    def test_qo_query_kernel(self, card):
        rng = np.random.default_rng(6)
        for C, occupied in ((1024, 300), (96, 1), (3000, 2000), (64, 0)):
            n = np.zeros(C, np.float32)
            n[rng.choice(C, occupied, replace=False)] = rng.integers(
                1, 9, occupied)
            planes = [torch.tensor(a, device=card) for a in (
                n, np.where(n > 0, rng.normal(0, 3, C), 0).astype(np.float32),
                np.where(n > 1, rng.uniform(0, 2, C), 0).astype(np.float32),
                (n * (np.arange(C) + rng.uniform(0, 1, C))).astype(
                    np.float32))]
            ks, kc, kr = qo_query.best_kernel(*planes)
            ps, pc, pr = qo_query.best_plain(*planes)
            assert torch.equal(torch.isneginf(ks), torch.isneginf(ps))
            fin = torch.isfinite(ps)
            torch.testing.assert_close(ks[fin], ps[fin], rtol=TOL, atol=TOL)
            torch.testing.assert_close(kc, pc, rtol=TOL, atol=TOL)
            torch.testing.assert_close(kr, pr, rtol=TOL, atol=TOL)
            assert float(kr[2]) == float(occupied >= 2)
