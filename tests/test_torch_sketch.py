"""Port parity: the sketch observer (``repro_torch.core.sketch``, the
``sketch_*`` ops, the sketch compaction kernel module) and the tree and
forest under ``observer_backend="sketch"``.

The same numpy inputs go through the JAX package (``core/sketch.py``,
``ops.sketch_*`` with ``backend="jnp"`` and ``"interpret"``, the
``kernels/ref.py`` oracles) and through the port on the CPU.  Bucket ids,
counts (integer weights) and topology must match exactly; f32 planes,
thresholds and statistics within 1e-4.  The merge-algebra properties of
``tests/test_sketch.py`` are held by the port's own sketches.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import forest as jfr
from repro.core import hoeffding as jht
from repro.core import qo as jqo
from repro.core import serve as jsv
from repro.core import sketch as jsk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_compact as jsc
from repro_torch import convert
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import qo as tqo
from repro_torch.core import serve as tsv
from repro_torch.core import sketch as tsk
from repro_torch.data import synth
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sketch_compact
from tests.helpers import repeat_by_weights
from tests.test_torch_forest import learn_both

TOL = 1e-4
RANK_SLACK = 4.0   # rank-error budget per merge level, in units of 1/K
PLANES = ("n", "mean", "m2", "sum_x")


def t(a):
    return torch.tensor(np.asarray(a))


def assert_planes_hold(port, ref, what=""):
    """Four planes: n exact, the rest within 1e-4 (NaN where NaN)."""
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref[0]),
                                  err_msg=f"{what}n")
    for name, p, r in zip(PLANES[1:], port[1:], ref[1:]):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}{name}")


def random_planes(rng, shape, occupied=0.7):
    """Unsorted centroid planes with integer weights, empty slots, +-0.0
    and NaN prototypes."""
    n = (rng.integers(1, 6, shape) * (rng.random(shape) < occupied)
         ).astype(np.float32)
    mean = np.where(n > 0, rng.normal(0, 2, shape), 0).astype(np.float32)
    m2 = np.where(n > 1, rng.uniform(0, 3, shape), 0).astype(np.float32)
    sum_x = (n * rng.normal(0, 1, shape)).astype(np.float32)
    flat = sum_x.reshape(-1)
    flat[::7] = 0.0
    flat[3::7] = -0.0
    flat[5::29] = np.nan
    return n, mean, m2, sum_x


@pytest.mark.parametrize("J,k", [(8, 4), (32, 16), (48, 16)])
def test_sort_buckets_and_compaction_match_reference(J, k):
    rng = np.random.default_rng(J + k)
    planes = random_planes(rng, (5, 3, J))
    port_sorted = tsk.sort_planes(*map(t, planes))
    ref_sorted = jsk.sort_planes(*map(jnp.asarray, planes))
    for p, r in zip(port_sorted, ref_sorted):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        tsk._bucket_ids(port_sorted[0], k).numpy(),
        np.asarray(jsk._bucket_ids(ref_sorted[0], k)))
    assert_planes_hold(tsk.compact_planes(*map(t, planes), k),
                       jsk.compact_planes(*map(jnp.asarray, planes), k))


def test_merge_planes_matches_reference():
    rng = np.random.default_rng(5)
    a = tsk.compact_planes(*map(t, random_planes(rng, (4, 2, 24))), 12)
    b = tsk.compact_planes(*map(t, random_planes(rng, (4, 2, 24))), 12)
    to_j = lambda ps: [jnp.asarray(p.numpy()) for p in ps]
    assert_planes_hold(tsk.merge_planes(*a, *b),
                       jsk.merge_planes(*to_j(a), *to_j(b)))


# --------------------------------------------------------------------------
# the compaction kernel's order of work, modelled on the CPU
# (csrc/sketch_compact.cu: 64-bit keys, a bitonic network, the ids of the
# reference's operation order)
# --------------------------------------------------------------------------

def ordered_key(p):
    """The kernel's ``ordered``: p + 0.0 as an unsigned 32-bit integer
    (held in int64) whose order is float order, every NaN above +inf."""
    p = p + 0.0
    u = p.view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(p), 0xFFFFFFFF, u)


def bitonic_order(p):
    """The kernel's sort of the (R, J) prototypes ``p``: keys
    ``(ordered << 32) | j`` padded with ~0 to a power of two (at least 32,
    one warp), through the bitonic network the warp runs with
    ``__shfl_xor_sync`` (and the general kernel in shared memory).
    Returns the (R, J) source index of each sorted position."""
    R, J = p.shape
    P = max(32, 1 << (J - 1).bit_length())
    keys = np.full((R, P), np.uint64(0xFFFFFFFFFFFFFFFF))
    keys[:, :J] = (ordered_key(p).numpy().astype(np.uint64) << np.uint64(32)) \
        | np.arange(J, dtype=np.uint64)
    lane = np.arange(P)
    k = 2
    while k <= P:
        j = k // 2
        while j:
            other = keys[:, lane ^ j]
            keep_min = ((lane & j) == 0) == ((lane & k) == 0)
            keys = np.where(keep_min, np.minimum(keys, other),
                            np.maximum(keys, other))
            j //= 2
        k *= 2
    return torch.from_numpy((keys[:, :J] & np.uint64(0xFFFFFFFF))
                            .astype(np.int64))


SPECIALS = np.array([-1.5, -0.0, 0.0, 1.0, 2.5, np.inf, -np.inf, np.nan,
                     1e-45, -1e-45, 3.4e38], np.float32)


def tied_prototypes(rng, R, J, all_empty):
    """(n, sum_x) rows whose prototypes repeat (ties), carry +-0.0, NaN,
    +-inf and subnormals, with empty centroids (+inf keys) and, if asked,
    rows of empties only."""
    n = rng.integers(0, 4, (R, J)).astype(np.float32)
    if all_empty:
        n[rng.random(R) < 0.5] = 0.0
    proto = rng.choice(SPECIALS, (R, J))
    with np.errstate(over="ignore", invalid="ignore"):
        sum_x = (n * proto).astype(np.float32)
    sum_x[(n > 0) & np.isnan(proto)] = np.nan
    return n, sum_x


def test_ordered_key_is_the_sort_order():
    """Unsigned order of the keys = float order with -0.0 == +0.0 and every
    NaN (either sign) above +inf; equal keys exactly for equal values."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([SPECIALS, -SPECIALS, np.float32([
        np.float32(np.nan) * -1]), rng.normal(0, 1e3, 200).astype(
        np.float32)]).astype(np.float32)
    p = torch.tensor(vals)
    key = ordered_key(p)
    assert ((key >= 0) & (key <= 0xFFFFFFFF)).all()
    canon = p + 0.0
    nan = torch.isnan(canon)
    for i in range(len(vals)):
        for j in range(len(vals)):
            if nan[i] or nan[j]:
                want = (nan[i] and not nan[j], nan[i] == nan[j])
            else:
                want = (bool(canon[i] > canon[j]), bool(canon[i] == canon[j]))
            assert (bool(key[i] > key[j]), bool(key[i] == key[j])) == want
    assert torch.equal(torch.sort(key, stable=True).indices,
                       torch.sort(canon, stable=True).indices)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       J=st.sampled_from([1, 2, 31, 32, 33, 64, 512]),
       all_empty=st.booleans())
def test_bitonic_network_is_the_stable_sort(seed, J, all_empty):
    """The kernel's network over (ordered key, index) gives exactly
    ``torch.sort(stable=True).indices`` of the plain version's keys: ties
    by index, empties last, NaN after the empties."""
    rng = np.random.default_rng(seed)
    n, sum_x = tied_prototypes(rng, 4, J, all_empty)
    key = tsk.prototypes(t(n), t(sum_x)) + 0.0
    assert torch.equal(bitonic_order(key),
                       torch.sort(key, dim=-1, stable=True).indices)


@pytest.mark.parametrize("J,k", [(2, 4), (32, 16), (48, 16), (64, 32),
                                 (48, 12), (64, 24)])
def test_compact_plain_matches_reference(J, k):
    """``compact_plain`` (the CPU path of ``compact``) against the
    reference's ``compact_planes`` (jnp) and, for the reduction stage,
    ``sketch_compact_pallas`` in interpret mode on the same sorted planes
    and ids; one plane set, and the same centroids as two sets."""
    rng = np.random.default_rng(J * k)
    planes = random_planes(rng, (4, 3, J))
    port = sketch_compact.compact(list(map(t, planes)), k)
    assert_planes_hold(port, jsk.compact_planes(*map(jnp.asarray, planes),
                                                k))
    half = J // 2
    split = sketch_compact.compact([t(a[..., :half]) for a in planes], k,
                                   [t(a[..., half:]) for a in planes])
    for a, b in zip(split, port):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # the Pallas body sums each bucket as a masked reduction of the whole
    # row, so one NaN sum_x poisons every bucket of its row (ROADMAP C10):
    # the interpret comparison runs on finite sum_x
    planes = planes[:3] + (np.nan_to_num(planes[3]),)
    srt = jsk.sort_planes(*map(jnp.asarray, planes))
    bucket = jsk._bucket_ids(srt[0], k)
    dense = jsc.sketch_compact_pallas(
        jsc.pack_compact_planes(*srt, bucket, tile_r=8), k_out=k, tile_r=8,
        interpret=True)
    ref = jsc.unpack_compact_planes(dense, srt[0].shape[:-1], k)
    mine = sketch_compact.bucket_reduce_plain(
        *(t(np.asarray(a)) for a in srt), t(np.asarray(bucket)), k)
    assert_planes_hold(mine, ref)


def test_compact_plain_holds_reference_merge_on_both_backends():
    """``compact_plain`` of two sketches = the reference's ``sketch_merge``
    on jnp and interpret (finite sum_x: ROADMAP C10)."""
    rng = np.random.default_rng(9)
    a, b = ([np.nan_to_num(np.asarray(p)) for p in tsk.compact_planes(
        *map(t, random_planes(rng, (6, 2, 20))), 16)] for _ in range(2))
    port = sketch_compact.compact_plain(list(map(t, a)), 16, list(map(t, b)))
    ry = lambda ps: ({"n": jnp.asarray(ps[0]), "mean": jnp.asarray(ps[1]),
                      "m2": jnp.asarray(ps[2])}, jnp.asarray(ps[3]))
    for bk in ("jnp", "interpret"):
        assert_planes_hold(port, tables(jops.sketch_merge(*ry(a), *ry(b),
                                                          backend=bk)), bk)


def batch_with_edges(rng, B, F, n_tables):
    """Rows with +-0.0 and NaN x, dropped rows (leaf -1) and one table
    (id 1) that receives no row; integer weights."""
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    X[::5, 0] = 0.0
    X[2::5, 0] = -0.0
    X[1::9, -1] = np.nan
    leaf = rng.choice(np.array([t_ for t_ in range(n_tables) if t_ != 1]),
                      B).astype(np.int32)
    leaf[rng.random(B) < 0.1] = -1
    y = rng.normal(0, 2, B).astype(np.float32)
    w = rng.integers(0, 5, B).astype(np.float32)
    return leaf, X, y, w


@pytest.mark.parametrize("B,k", [(1, 4), (97, 8), (1500, 32), (997, 12),
                                 (500, 24)])
def test_from_batch_planes_matches_reference(B, k):
    rng = np.random.default_rng(B)
    n_tables, F = 6, 3
    leaf, X, y, w = batch_with_edges(rng, B, F, n_tables)
    port = tsk.from_batch_planes(t(leaf), t(X), t(y), t(w), n_tables, k)
    ref = jsk.from_batch_planes(*map(jnp.asarray, (leaf, X, y, w)),
                                n_tables, k)
    assert_planes_hold(port, ref)
    assert float(port[0][1].sum()) == 0.0          # the table with no row
    assert float(port[0].sum()) == F * float(w[leaf >= 0].sum())


def test_from_batch_planes_folded_rows_read_x_by_row_mod_b():
    """R = T*B folded rows read X[r % B]: the same as the tiled batch."""
    rng = np.random.default_rng(11)
    T, B, F, k = 3, 40, 2, 8
    leaf = rng.integers(0, 12, T * B).astype(np.int32)
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    y = rng.normal(0, 1, B).astype(np.float32)
    w = rng.integers(0, 4, T * B).astype(np.float32)
    port = tsk.from_batch_planes(t(leaf), t(X), t(y), t(w), 12, k)
    ref = jsk.from_batch_planes(jnp.asarray(leaf),
                                jnp.asarray(np.tile(X, (T, 1))),
                                jnp.asarray(np.tile(y, T)), jnp.asarray(w),
                                12, k)
    assert_planes_hold(port, ref)


def test_recompaction_is_not_the_identity():
    """A compact sketch re-buckets: weights [1, 1, 1, 97] at K = 4 go to
    buckets [0, 0, 0, 2], so an absorb must re-compact every table, also a
    leaf's that received no row, as the reference does."""
    n = np.array([[1, 1, 1, 97]], np.float32)
    mean = np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)
    sum_x = n * np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    m2 = np.zeros_like(n)
    np.testing.assert_array_equal(tsk._bucket_ids(t(n), 4).numpy(),
                                  [[0, 0, 0, 2]])
    port = tsk.compact_planes(t(n), t(mean), t(m2), t(sum_x), 4)
    np.testing.assert_array_equal(port[0].numpy(), [[3, 0, 97, 0]])
    assert_planes_hold(port, jsk.compact_planes(
        *map(jnp.asarray, (n, mean, m2, sum_x)), 4))

    # an absorb that routes no row to table 0 still re-compacts it
    ao = {"n": np.tile(n, (3, 2, 1)), "mean": np.tile(mean, (3, 2, 1)),
          "m2": np.tile(m2, (3, 2, 1))}
    ao_sx = np.tile(sum_x, (3, 2, 1))
    rng = np.random.default_rng(2)
    leaf = rng.integers(1, 3, 30).astype(np.int32)
    X = rng.normal(0, 1, (30, 2)).astype(np.float32)
    y = rng.normal(0, 1, 30).astype(np.float32)
    py, psx = tops.sketch_update({k_: t(v) for k_, v in ao.items()}, t(ao_sx),
                                 t(leaf), t(X), t(y))
    ry, rsx = jops.sketch_update({k_: jnp.asarray(v) for k_, v in ao.items()},
                                 jnp.asarray(ao_sx), jnp.asarray(leaf),
                                 jnp.asarray(X), jnp.asarray(y),
                                 backend="jnp")
    assert_planes_hold((py["n"], py["mean"], py["m2"], psx),
                       (ry["n"], ry["mean"], ry["m2"], rsx))
    np.testing.assert_array_equal(py["n"][0, 0].numpy(), [3, 0, 97, 0])


def rand_sketch_state(seed, M=5, F=3, K=8, B=96):
    """Sketch tables built from one batch, plus a second batch with
    dropped rows (the reference's ``tests/test_sketch.py::_rand_state``)."""
    rng = np.random.default_rng(seed)
    leaf = rng.integers(0, M, size=B).astype(np.int32)
    leaf[rng.random(B) < 0.1] = -1
    X = rng.normal(size=(B, F)).astype(np.float32)
    y = rng.normal(size=B).astype(np.float32)
    w = rng.integers(0, 3, size=B).astype(np.float32)
    n, mean, m2, sum_x = (np.asarray(a) for a in jsk.from_batch_planes(
        jnp.asarray(np.maximum(leaf, 0)), jnp.asarray(X) + 10.0,
        jnp.asarray(y), jnp.ones(B, jnp.float32), M, K))
    return {"n": n, "mean": mean, "m2": m2}, sum_x, leaf, X, y, w


def as_port(ao_y, ao_sx):
    return {k: t(v) for k, v in ao_y.items()}, t(ao_sx)


def as_ref(ao_y, ao_sx):
    return {k: jnp.asarray(v) for k, v in ao_y.items()}, jnp.asarray(ao_sx)


def tables(pair):
    ao_y, ao_sx = pair
    return ao_y["n"], ao_y["mean"], ao_y["m2"], ao_sx


def test_sketch_update_matches_ref_oracle_and_both_backends():
    ao_y, ao_sx, leaf, X, y, w = rand_sketch_state(80)
    port = tops.sketch_update(*as_port(ao_y, ao_sx), t(leaf), t(X), t(y),
                              t(w))
    refs = [jref.sketch_update_ref(*as_ref(ao_y, ao_sx),
                                   *map(jnp.asarray, (leaf, X, y, w)))]
    refs += [jops.sketch_update(*as_ref(ao_y, ao_sx),
                                *map(jnp.asarray, (leaf, X, y, w)),
                                backend=b) for b in ("jnp", "interpret")]
    for ref in refs:
        assert_planes_hold(tables(port), tables(ref))


def test_sketch_merge_matches_ref_oracle_and_both_backends():
    a = rand_sketch_state(81)[:2]
    b = rand_sketch_state(82)[:2]
    port = tops.sketch_merge(*as_port(*a), *as_port(*b))
    refs = [jref.sketch_merge_ref(*as_ref(*a), *as_ref(*b))]
    refs += [jops.sketch_merge(*as_ref(*a), *as_ref(*b), backend=bk)
             for bk in ("jnp", "interpret")]
    for ref in refs:
        assert_planes_hold(tables(port), tables(ref))


def test_sketch_to_bins_idempotent_and_merit_preserving():
    ao = as_port(*rand_sketch_state(87)[:2])
    d = tops.sketch_to_bins(*ao)
    d2 = tops.sketch_to_bins(*d)
    for a, b in zip(tables(d), tables(d2)):
        assert torch.equal(a, b)
    attempt = torch.ones(ao[1].shape[0], dtype=torch.bool)
    raw = tops.forest_best_splits(*ao, attempt)
    via = tops.forest_best_splits(*d, attempt)
    np.testing.assert_allclose(raw[0].numpy(), via[0].numpy(), rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# the port's own merge-algebra properties (tests/test_sketch.py:113-290)
# --------------------------------------------------------------------------

def lognormal(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 1.0, size=n).astype(np.float32)
    y = (np.log(x) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def sketch(x, y, w=None, k=16):
    return tsk.from_batch(x, y, w, k=k, device="cpu")


def rank(xs, v):
    return float(np.mean(np.asarray(xs, np.float64) <= float(v)))


def planes_of(s):
    return [s["y"]["n"], s["y"]["mean"], s["y"]["m2"], s["sum_x"]]


def test_empty_and_single_element():
    e = tsk.init(8, device="cpu")
    assert int(tsk.n_slots(e)) == 0
    for a, b in zip(planes_of(tsk.merge(e, e)), planes_of(e)):
        assert torch.equal(a, b)
    s = sketch(np.float32([3.0]), np.float32([2.0]), k=8)
    assert int(tsk.n_slots(s)) == 1
    assert float(tsk.total_stats(s)["n"]) == 1.0
    assert not bool(tsk.best_split(s, device="cpu").valid)
    for m in (tsk.merge(s, e), tsk.merge(e, s)):
        tot = tsk.total_stats(m)
        assert float(tot["n"]) == 1.0
        assert float(tot["mean"]) == pytest.approx(2.0)


def test_merge_commutative_bitwise_on_distinct_prototypes():
    xa, ya = lognormal(11, 300)
    xb, yb = lognormal(12, 300)
    a, b = sketch(xa, ya), sketch(xb + 100.0, yb)
    for p, q in zip(planes_of(tsk.merge(a, b)), planes_of(tsk.merge(b, a))):
        assert torch.equal(p, q)


def test_merge_associative_within_rank_eps():
    k = 32
    parts = [lognormal(20 + i, 400) for i in range(3)]
    ts = [sketch(x, y, k=k) for x, y in parts]
    left = tsk.merge(tsk.merge(ts[0], ts[1]), ts[2])
    right = tsk.merge(ts[0], tsk.merge(ts[1], ts[2]))
    for key in ("n", "mean", "m2"):
        np.testing.assert_allclose(float(tsk.total_stats(left)[key]),
                                   float(tsk.total_stats(right)[key]),
                                   rtol=1e-5)
    xs = np.concatenate([p[0] for p in parts])
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert abs(rank(xs, tsk.quantile_sk(left, q))
                   - rank(xs, tsk.quantile_sk(right, q))) <= RANK_SLACK / k


def test_merge_equals_single_pass_within_rank_eps():
    k = 32
    xa, ya = lognormal(31, 600)
    xb, yb = lognormal(32, 600)
    merged = tsk.merge(sketch(xa, ya, k=k), sketch(xb, yb, k=k))
    single = sketch(np.concatenate([xa, xb]), np.concatenate([ya, yb]), k=k)
    for key in ("n", "mean", "m2"):
        np.testing.assert_allclose(float(tsk.total_stats(merged)[key]),
                                   float(tsk.total_stats(single)[key]),
                                   rtol=1e-5)
    xs = np.concatenate([xa, xb])
    for q in (0.1, 0.25, 0.5, 0.75, 0.9):
        rm = rank(xs, tsk.quantile_sk(merged, q))
        assert abs(rm - rank(xs, tsk.quantile_sk(single, q))) \
            <= RANK_SLACK / k
        assert abs(rm - q) <= RANK_SLACK / k


def test_capacity_saturation():
    k = 16
    x, y = lognormal(40, 2500)
    s = sketch(x, y, k=k)
    n, _, _, sum_x = (p.numpy() for p in planes_of(s))
    assert int(tsk.n_slots(s)) == k and n.shape == (k,)
    np.testing.assert_allclose(float(n.sum()), 2500.0, rtol=1e-6)
    protos = sum_x / n
    assert np.all(np.diff(protos) > 0)
    assert protos.min() >= x.min() and protos.max() <= x.max()
    s2 = tsk.update(s, *lognormal(41, 2500), device="cpu")
    assert int(tsk.n_slots(s2)) == k
    np.testing.assert_allclose(float(tsk.total_stats(s2)["n"]), 5000.0,
                               rtol=1e-6)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 13), (2, 30), (50, 64)])
def test_weighted_equals_repeated_total_stats(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    w = rng.integers(0, 5, size=n)
    w[0] = max(w[0], 1)
    xr, yr = repeat_by_weights(w, x, y)
    tw, tr = sketch(x, y, w.astype(np.float32), k=8), sketch(xr, yr, k=8)
    for key in ("n", "mean", "m2"):
        np.testing.assert_allclose(float(tsk.total_stats(tw)[key]),
                                   float(tsk.total_stats(tr)[key]),
                                   rtol=1e-4, atol=1e-4)


def test_weighted_equals_repeated_slotwise_when_aligned():
    k, w = 8, 5
    rng = np.random.default_rng(51)
    x = np.sort(rng.normal(size=k)).astype(np.float32)
    y = rng.normal(size=k).astype(np.float32)
    tw = sketch(x, y, np.full(k, float(w), np.float32), k=k)
    tr = sketch(*repeat_by_weights(np.full(k, w), x, y), k=k)
    for a, b in zip(planes_of(tw), planes_of(tr)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_quantile_rank_error_bound():
    k = 32
    x, y = lognormal(60, 4000)
    s = tsk.init(k, device="cpu")
    for c in np.array_split(np.arange(4000), 4):
        s = tsk.update(s, x[c], y[c], device="cpu")
    for q in np.linspace(0.05, 0.95, 19):
        assert abs(rank(x, tsk.quantile_sk(s, float(q))) - q) \
            <= RANK_SLACK / k


def test_single_table_surface_matches_reference():
    x, y = lognormal(70, 900)
    w = np.random.default_rng(70).integers(0, 3, 900).astype(np.float32)
    port = tsk.update(sketch(x[:400], y[:400]), x[400:], y[400:], w[400:],
                      device="cpu")
    ref = jsk.update(jsk.from_batch(x[:400], y[:400], k=16), x[400:],
                     y[400:], w[400:])
    assert_planes_hold(planes_of(port), (ref["y"]["n"], ref["y"]["mean"],
                                         ref["y"]["m2"], ref["sum_x"]))
    ps, rs = tsk.best_split(port, device="cpu"), jsk.best_split(ref)
    assert bool(ps.valid) == bool(rs.valid)
    np.testing.assert_allclose([float(ps.threshold), float(ps.merit)],
                               [float(rs.threshold), float(rs.merit)],
                               rtol=TOL, atol=TOL)
    q = [0.1, 0.5, 0.9]
    np.testing.assert_allclose(tsk.quantile_sk(port, q).numpy(),
                               np.asarray(jsk.quantile_sk(ref, q)),
                               rtol=TOL, atol=TOL)


def test_qo_table_quantile_and_summary_match_reference():
    rng = np.random.default_rng(71)
    x = rng.normal(0, 1, 3000).astype(np.float32)
    y = (x ** 2).astype(np.float32)
    table = tqo.update(tqo.init(128, 0.05, device="cpu"), x, y,
                       device="cpu")
    jt = jqo.update(jqo.init(128, 0.05), jnp.asarray(x), jnp.asarray(y))
    port, ref = tsk.summary(table), jsk.summary(jt)
    for key in ref:
        np.testing.assert_allclose(float(port[key]), float(ref[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    np.testing.assert_allclose(float(tsk.quantile(table, 0.3)),
                               float(jsk.quantile(jt, 0.3)), rtol=TOL,
                               atol=TOL)


# --------------------------------------------------------------------------
# the tree and the forest under the sketch observer
# --------------------------------------------------------------------------

TREE_KW = dict(n_features=4, max_nodes=63, n_bins=32, grace_period=100,
               max_depth=6, r0=0.25, observer_backend="sketch", sketch_k=16)
TOPOLOGY = ("feature", "child", "is_leaf", "depth", "n_nodes")


def heavy_tailed(n, seed):
    """The piecewise stream with X fed as exp(X): heavy-tailed, monotone,
    so the planted splits survive."""
    X, y = synth.piecewise_regression(n, 4, seed=seed)
    return np.exp(X).astype(np.float32), y


def test_config_accepts_the_sketch_and_validates_it():
    cfg = tht.HTRConfig(n_features=3, observer_backend="sketch", sketch_k=24)
    assert cfg.observer_bins() == 24
    assert tht.HTRConfig(n_features=3).observer_bins() == 64
    with pytest.raises(ValueError, match="sketch_k"):
        tht.HTRConfig(n_features=3, observer_backend="sketch", sketch_k=1)
    with pytest.raises(ValueError, match="observer_backend"):
        tht.HTRConfig(n_features=3, observer_backend="bogus")
    s = tht.init_state(cfg, device="cpu")
    assert s["ao_y"]["n"].shape == (127, 3, 24)


@pytest.mark.parametrize("schedule,decision", [
    ("grace", "hoeffding"), ("eager", "hoeffding"), ("eager", "anytime")])
def test_tree_under_sketch_matches_reference(schedule, decision):
    kw = dict(TREE_KW, attempt_schedule=schedule, decision_backend=decision)
    jc = jht.HTRConfig(split_backend="jnp", **kw)
    tc = tht.HTRConfig(**kw)
    jupd = jax.jit(functools.partial(jht.update, jc))
    js, ts = jht.init_state(jc), tht.init_state(tc, device="cpu")
    X, y = heavy_tailed(3000, 5)
    for i in range(0, 3000, 250):
        js = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
        ts = tht.update(tc, ts, X[i:i + 250], y[i:i + 250], device="cpu")
        port = convert.state_to_numpy(ts)
        for k in TOPOLOGY:
            np.testing.assert_array_equal(port[k], np.asarray(js[k]),
                                          err_msg=f"batch {i}: {k}")
        np.testing.assert_allclose(port["threshold"],
                                   np.asarray(js["threshold"]), rtol=TOL,
                                   atol=TOL)
        assert_planes_hold([t(port["ao_y"][k]) for k in ("n", "mean", "m2")]
                           + [t(port["ao_sum_x"])],
                           [js["ao_y"][k] for k in ("n", "mean", "m2")]
                           + [js["ao_sum_x"]], f"batch {i}: ")
        np.testing.assert_allclose(port["dec_logE"],
                                   np.asarray(js["dec_logE"]), rtol=TOL,
                                   atol=TOL)
    assert int(ts["n_nodes"]) > 1, "the tree never split"


def sketch_forest_pair(T=3):
    jc = jfr.ForestConfig(tree=jht.HTRConfig(split_backend="jnp", **TREE_KW),
                          n_trees=T)
    tc = tfr.ForestConfig(tree=tht.HTRConfig(**TREE_KW), n_trees=T)
    return jc, tc, jfr.init_forest(jc, jax.random.PRNGKey(0))


def test_forest_under_sketch_matches_reference_with_injected_draws():
    jc, tc, js = sketch_forest_pair()
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = heavy_tailed(2000, 17)
    js, ts = learn_both(jc, tc, js, ts, X, y, jupd)
    assert (np.asarray(js["trees"]["n_nodes"]) > 1).all()


def test_freeze_under_sketch_drops_the_planes_and_serves_live():
    jc, tc, js = sketch_forest_pair(T=2)
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = heavy_tailed(1500, 23)
    for i in range(0, 1500, 250):
        js, _ = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    snap = tsv.freeze(ts, version=1, step=7, device="cpu")
    assert not any(f.startswith("ao_") for f in vars(snap))
    jsnap = jsv.freeze(js, version=1, step=7)
    for k, v in convert.snapshot_to_numpy(snap).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsnap, k)))
    assert torch.equal(tsv.predict_snapshot(snap, X[:64], device="cpu"),
                       tfr.predict(tc, ts, X[:64], device="cpu"))
