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


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def card_streams(n=5000, seed=0):
    """The card cases: an i.i.d. stream, one with duplicates, one with
    NaN and +-inf, and one past capacity."""
    rng = np.random.default_rng(seed)
    x, y = stream(rng, n)
    dup = np.round(x, 1).astype(np.float32)
    ext = x.copy()
    ext[rng.integers(0, n, 40)] = np.nan
    ext[rng.integers(0, n, 20)] = np.inf
    ext[rng.integers(0, n, 20)] = -np.inf
    ext[rng.integers(0, n, 20)] = -0.0
    return {"iid": (x, y, n), "duplicates": (dup, y, n),
            "extremes": (ext, y, n), "past_capacity": (x, y, n // 4)}


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
                                      "past_capacity"])
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
