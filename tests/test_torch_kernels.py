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
from repro_torch.kernels import (qo_query, qo_query_batched, qo_route,
                                 qo_update, qo_update_leaves, sketch_compact)

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
        out = []
        for fn in (qo_update_leaves.absorb_kernel,
                   qo_update_leaves.absorb_plain):
            ty = {k: torch.tensor(v, device=card) for k, v in tab_y.items()}
            tsx = torch.tensor(sum_x, device=card)
            fn(ty, tsx, *args)
            out.append(({k: v.cpu().numpy() for k, v in ty.items()},
                        tsx.cpu().numpy()))
        (ky, ksx), (py, psx) = out
        np.testing.assert_array_equal(ky["n"], py["n"])
        for k in ("mean", "m2"):
            np.testing.assert_allclose(ky[k], py[k], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ksx, psx, rtol=TOL, atol=TOL)

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

    def test_qo_update_kernel(self, card):
        rng = np.random.default_rng(5)
        C, N = 256, 20000
        n = rng.integers(0, 4, C).astype(np.float32)
        table = [torch.tensor(a, device=card) for a in (
            n, np.where(n > 0, rng.normal(0, 1, C), 0).astype(np.float32),
            np.where(n > 1, rng.uniform(0, 1, C), 0).astype(np.float32),
            (n * rng.normal(0, 1, C)).astype(np.float32))]
        x = rng.normal(0, 1, N).astype(np.float32)
        x[:6] = [1e10, np.inf, -np.inf, np.nan, 0.0, -0.0]
        args = [torch.tensor(np.float32(0.02), device=card),
                torch.tensor(np.float32(0.1), device=card)] + [
            torch.tensor(a, device=card) for a in (
                x, rng.normal(0, 2, N).astype(np.float32),
                rng.integers(0, 5, N).astype(np.float32))]
        k = qo_update.update_kernel(*table, *args)
        p = qo_update.update_plain(*table, *args)
        assert torch.equal(k[0], p[0])
        for a, b in zip(k[1:], p[1:]):
            torch.testing.assert_close(a, b, rtol=TOL, atol=TOL,
                                       equal_nan=True)
        again = qo_update.update_kernel(*table, *args)
        assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                   for a, b in zip(k, again))

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
