"""Port parity: the E-BST / TE-BST baselines (``repro_torch.core.ebst``)
against the JAX package's ``repro.core.ebst``.

The same numpy stream goes into both (the reference jitted, the port's
plain version on the CPU).  The structure must match exactly (``size``,
``key``, ``left``, ``right``) and so must the split threshold (a stored
key); the node statistics, the total and the merit within 1e-4 (XLA may
contract a product and a sum into an FMA, which the port does not).
``TestOnCard`` holds the CUDA kernel bitwise against the plain version;
it needs a GPU and skips without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebst as rebst
from repro_torch.core import ebst as tebst
from repro_torch.kernels import _build
from repro_torch.kernels import ebst as kebst

TOL = 1e-4


def stream(rng, n):
    x = rng.normal(0, 1, n).astype(np.float32)
    y = np.where(x <= 0.3, 1.0, 6.0).astype(np.float32) \
        + 0.1 * rng.normal(0, 1, n).astype(np.float32)
    return x, y


def reference(cap, decimals, x, y):
    t = jax.jit(rebst.update)(rebst.init(cap, decimals), jnp.asarray(x),
                              jnp.asarray(y))
    return t, jax.jit(rebst.best_split)(t)


def port(cap, decimals, x, y):
    t = tebst.update(tebst.init(cap, decimals, device="cpu"), x, y,
                     device="cpu")
    return t, tebst.best_split(t, device="cpu")


def assert_matches_reference(t, s, r, rs):
    assert int(t["size"]) == int(r["size"])
    for k in ("key", "left", "right"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(r[k]),
                                      err_msg=k)
    for part in ("le", "total"):
        for k in ("n", "mean", "m2"):
            np.testing.assert_allclose(t[part][k].numpy(),
                                       np.asarray(r[part][k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{part}/{k}")
    assert bool(s.valid) == bool(rs.valid)
    assert float(s.threshold) == float(rs.threshold)
    np.testing.assert_allclose(float(s.merit), float(rs.merit), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("decimals", [-1, 3, 1])
@pytest.mark.parametrize("n", [300, 1500])
def test_matches_reference(decimals, n):
    x, y = stream(np.random.default_rng(n + decimals), n)
    cap = n + 7
    assert_matches_reference(*port(cap, decimals, x, y),
                             *reference(cap, decimals, x, y))


def test_batches_accumulate_like_one_stream():
    """Two updates equal one update of the whole stream; the input tree is
    not modified (out of place)."""
    x, y = stream(np.random.default_rng(5), 400)
    t0 = tebst.init(500, device="cpu")
    half = tebst.update(t0, x[:200], y[:200], device="cpu")
    two = tebst.update(half, x[200:], y[200:], device="cpu")
    one = tebst.update(t0, x, y, device="cpu")
    assert int(t0["size"]) == 0 and int(half["size"]) == 200
    for k in ("key", "left", "right", "size"):
        assert torch.equal(two[k], one[k])
    for part in ("le", "total"):
        for k in ("n", "mean", "m2"):
            assert torch.equal(two[part][k], one[part][k])


def test_extreme_values_match_reference():
    """NaN (goes right, a node of its own), +-inf, +-0.0 (a duplicate of
    each other), and x.5 ties of the TE-BST rounding (half to even)."""
    x = np.array([0.0, -0.0, np.nan, 1.0, np.inf, -np.inf, np.nan, 0.25,
                  0.35, 0.45, -0.25, 2.5, 0.05, 0.15, -0.0, 1.0, 3.0],
                 np.float32)
    y = np.arange(x.shape[0], dtype=np.float32) % 5
    for decimals in (-1, 1, 0):
        cap = 32
        assert_matches_reference(*port(cap, decimals, x, y),
                                 *reference(cap, decimals, x, y))
    t, _ = port(32, -1, x, y)
    assert int(t["size"]) == 14     # -0.0 twice and 1.0 once are dups


def test_rounding_is_half_to_even():
    t, _ = port(8, 0, np.array([0.5, 1.5, 2.5, -0.5], np.float32),
                np.zeros(4, np.float32))
    assert sorted(t["key"][:int(t["size"])].tolist()) == [0.0, 2.0]


# ---- ports of the reference's own tests (tests/test_ebst.py) ------------

def test_ebst_split_matches_batch_oracle():
    from tests.helpers import exact_best_split
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 1500).astype(np.float32)
    y = np.where(x <= -0.3, 2.0, 7.0).astype(np.float32) + \
        0.05 * rng.normal(0, 1, 1500).astype(np.float32)
    _, r = port(1500, -1, x, y)
    merit, thr = exact_best_split(x, y)
    assert bool(r.valid)
    np.testing.assert_allclose(float(r.threshold), thr, rtol=1e-5)
    np.testing.assert_allclose(float(r.merit), merit, rtol=1e-3)


def test_tebst_truncates_and_stores_fewer():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, 2000).astype(np.float32)
    y = (3 * x).astype(np.float32)
    full, rf = port(2000, -1, x, y)
    trunc, rt = port(2000, 1, x, y)
    assert int(tebst.n_elements(trunc)) < int(tebst.n_elements(full))
    assert abs(float(rf.threshold) - float(rt.threshold)) < 0.1


def test_ebst_duplicate_keys():
    x = np.repeat(np.array([1.0, 2.0, 3.0], np.float32), 50)
    y = np.where(x <= 2.0, 0.0, 10.0).astype(np.float32)
    t, r = port(300, -1, x, y)
    assert int(t["size"]) == 3
    np.testing.assert_allclose(float(r.threshold), 2.0)
    assert float(t["total"]["n"]) == 150


def test_ebst_capacity_degrades_gracefully():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, 500).astype(np.float32)
    y = x.copy()
    t, r = port(100, -1, x, y)
    assert int(t["size"]) == 100
    assert float(t["total"]["n"]) == 500
    assert bool(r.valid) and np.isfinite(float(r.merit))
    assert_matches_reference(t, r, *reference(100, -1, x, y))


def test_empty_tree_has_no_split():
    t = tebst.init(4, device="cpu")
    s = tebst.best_split(t, device="cpu")
    assert not bool(s.valid) and float(s.merit) == 0.0
    assert float(s.threshold) == 0.0


def test_kernel_launchers_refuse_cpu_tensors():
    t = tebst.init(4, device="cpu")
    with pytest.raises(ValueError, match="ebst_insert"):
        kebst.insert_kernel(t, torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="ebst_query"):
        kebst.query_kernel(t)


# ---- the query kernel's algorithm, modelled on the CPU ------------------

def model_cases():
    """Trees the query model is held on: (x, y, capacity, decimals)."""
    rng = np.random.default_rng(11)
    x, y = stream(rng, 600)
    ext = x.copy()
    for v, count in ((np.nan, 30), (np.inf, 10), (-np.inf, 10), (-0.0, 10),
                     (0.0, 10)):
        ext[rng.integers(0, 600, count)] = v
    chain = np.sort(x[:300])
    return {
        "iid": (x, y, 600, -1),
        "tebst": (x, y, 600, 1),
        "sorted_chain": (chain, y[:300], 300, -1),
        "reversed_chain": (chain[::-1].copy(), y[:300], 300, -1),
        "constant_y": (x, np.full(600, 2.5, np.float32), 600, -1),
        "nan_inf_zero": (ext, y, 600, -1),
        "nan_inf_zero_constant_y": (ext, np.ones(600, np.float32), 600, -1),
        "nan_root_constant_y": (np.array([np.nan, 1, 2, np.nan, 3],
                                         np.float32),
                                np.full(5, 3.0, np.float32), 8, -1),
        "single_node": (x[:1], y[:1], 4, -1),
        "empty": (x[:0], y[:0], 4, -1),
        "past_capacity": (x, y, 150, -1),
    }


def bits_equal(a, b):
    """Equal values, NaN where NaN, signs of zeros too."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan], b[~nan]) and torch.equal(torch.signbit(a[~nan]),
                                          torch.signbit(b[~nan]))


def inorder(t):
    """Node ids in in-order, by an explicit walk."""
    left, right = t["left"].tolist(), t["right"].tolist()
    out, stack, v = [], [], 0 if int(t["size"]) else -1
    while stack or v != -1:
        while v != -1:
            stack.append(v)
            v = left[v]
        v = stack.pop()
        out.append(v)
        v = right[v]
    return out


@pytest.mark.parametrize("case", list(model_cases()))
def test_query_model_matches_plain_and_reference(case):
    """The query kernel's algorithm (level-wise left statistics, parallel
    scores, the in-order tie key) bitwise = the plain walk, and = the
    reference's ``best_split`` (threshold exact, merit within 1e-4)."""
    x, y, cap, dec = model_cases()[case]
    t, sp = port(cap, dec, x, y)
    model = kebst.query_model(t)
    for a, b in zip(model, (sp.threshold, sp.merit, sp.valid)):
        assert bits_equal(a, b)
    r = rebst.init(cap, dec) if x.shape[0] == 0 else reference(
        cap, dec, x, y)[0]
    rs = jax.jit(rebst.best_split)(r)
    assert bool(model[2]) == bool(rs.valid)
    assert bits_equal(model[0], torch.tensor(np.asarray(rs.threshold)))
    np.testing.assert_allclose(float(model[1]), float(rs.merit), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", list(model_cases()))
def test_inorder_keys_order_the_walk(case):
    """Sorting the nodes by the kernel's tie key gives the in-order walk,
    NaN keys on the right spine included; no two nodes share a key."""
    x, y, cap, dec = model_cases()[case]
    t, _ = port(cap, dec, x, y)
    keys = kebst.inorder_keys(t)
    assert torch.argsort(keys).tolist() == inorder(t)
    assert torch.unique(keys).numel() == keys.numel()


def test_query_model_levels_follow_the_context_forest():
    """A sorted stream's chain: ascending, every node's context is its
    parent's left statistics (c(v) = v - 1); descending, none has one."""
    x = np.arange(1, 41, dtype=np.float32)
    y = np.arange(40, dtype=np.float32) % 7
    up, _ = port(40, -1, x, y)
    _, _, c, levels = kebst._levels(up)
    assert c.tolist() == list(range(-1, 39)) and levels == 40
    down, _ = port(40, -1, x[::-1].copy(), y)
    _, _, c, _ = kebst._levels(down)
    assert c.tolist() == [-1] * 40


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_streams(n=5000, seed=0):
    """The card cases: an i.i.d. stream, one with duplicates, one with
    NaN and +-inf, one past capacity and one with constant targets (every
    VR ties at 0: the smallest key must win)."""
    rng = np.random.default_rng(seed)
    x, y = stream(rng, n)
    dup = np.round(x, 1).astype(np.float32)
    ext = x.copy()
    ext[rng.integers(0, n, 40)] = np.nan
    ext[rng.integers(0, n, 20)] = np.inf
    ext[rng.integers(0, n, 20)] = -np.inf
    ext[rng.integers(0, n, 20)] = -0.0
    return {"iid": (x, y, n), "duplicates": (dup, y, n),
            "extremes": (ext, y, n), "past_capacity": (x, y, n // 4),
            "constant_y": (x, np.full(n, 2.5, np.float32), n)}


def oracle_streams(seed=0):
    """Cases held against the single-thread kernels, where the plain
    versions take minutes: sorted streams (chains as deep as the tree is
    large) and a tree larger than the insert's shared-memory part."""
    rng = np.random.default_rng(seed)
    x, y = stream(rng, 50_000)
    chain = np.sort(x[:5000])
    return {"sorted_chain": (chain, y[:5000], 5000),
            "reversed_chain": (chain[::-1].copy(), y[:5000], 5000),
            "larger_than_shared": (x, y, 50_000)}


def same(a, b):
    """Bitwise equal values, NaN where NaN."""
    a = a.cpu()
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(
        a, dtype=torch.bool)
    return torch.equal(nan, torch.isnan(b) if b.is_floating_point()
                       else nan) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
class TestOnCard:
    """The E-BST kernels against their plain versions on the same card."""

    @pytest.mark.parametrize("decimals", [-1, 3])
    @pytest.mark.parametrize("case", ["iid", "duplicates", "extremes",
                                      "past_capacity", "constant_y"])
    def test_insert_and_query_bitwise(self, card, decimals, case):
        x, y, cap = card_streams()[case]
        t0 = tebst.init(cap, decimals, device=card)
        # two launches: a tree that is not empty takes the second batch
        before = dict(_build.LAUNCHES)
        k = tebst.update(t0, x[:1000], y[:1000], device=card)
        k = tebst.update(k, x[1000:], y[1000:], device=card)
        sk = tebst.best_split(k, device=card)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ebst_insert"] == before["ebst_insert"] + 2
        assert _build.LAUNCHES["ebst_query"] == before["ebst_query"] + 1
        p = tebst.update(tebst.init(cap, decimals, device="cpu"), x, y,
                         device="cpu")
        sp = tebst.best_split(p, device="cpu")
        for key in ("key", "left", "right", "size"):
            assert same(k[key], p[key]), key
        for part in ("le", "total"):
            for key in ("n", "mean", "m2"):
                assert same(k[part][key], p[part][key]), f"{part}/{key}"
        for a, b in zip(sk, sp):
            assert same(a, b)
        again = tebst.update(tebst.update(t0, x[:1000], y[:1000],
                                          device=card),
                             x[1000:], y[1000:], device=card)
        for key in ("key", "left", "right", "size"):
            assert same(again[key], k[key].cpu())

    @pytest.mark.parametrize("decimals", [-1, 3])
    @pytest.mark.parametrize("case", list(oracle_streams()))
    def test_against_serial_oracle(self, card, decimals, case):
        """Bitwise = the single-thread kernels on trees whose plain walk
        takes minutes; two batches, reruns bitwise, launches counted."""
        x, y, cap = oracle_streams()[case]
        xt, yt = torch.as_tensor(x, device=card), torch.as_tensor(
            y, device=card)
        t0 = tebst.init(cap, decimals, device=card)
        runs = []
        for _ in range(2):
            before = dict(_build.LAUNCHES)
            k = tebst.update(t0, xt[:1000], yt[:1000], device=card)
            k = tebst.update(k, xt[1000:], yt[1000:], device=card)
            sk = tebst.best_split(k, device=card)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["ebst_insert"] == \
                before["ebst_insert"] + 2
            assert _build.LAUNCHES["ebst_query"] == before["ebst_query"] + 1
            runs.append((k, sk))
        o = {kk: ({a: b.clone() for a, b in v.items()} if isinstance(v, dict)
                  else v.clone()) for kk, v in t0.items()}
        before = dict(_build.LAUNCHES)
        kebst.insert_serial(o, xt[:1000], yt[:1000])
        kebst.insert_serial(o, xt[1000:], yt[1000:])
        so = kebst.query_serial(o)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == before     # the oracle is not counted
        for k, sk in runs:
            for key in ("key", "left", "right", "size"):
                assert same(k[key], o[key].cpu()), key
            for part in ("le", "total"):
                for key in ("n", "mean", "m2"):
                    assert same(k[part][key], o[part][key].cpu()), \
                        f"{part}/{key}"
            for a, b in zip(sk, so):
                assert same(a, b.cpu())
