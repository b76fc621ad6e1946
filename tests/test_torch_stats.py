"""Port parity: ``repro_torch.core.stats`` against ``repro.core.stats``.

Inputs are numpy arrays from a seeded generator, fed to both packages in
one process.  Merge and subtract follow the reference's operation order,
so on streams where every float op is exact (equal counts, integer means
of one parity, integer M2) the two agree bit for bit; on gaussian streams
they agree within 1e-4 (``tests/test_qo_batched.py``'s tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as jstats
from repro_torch.core import stats as tstats

TOL = 1e-4


def _pair(d):
    """The same stats dict for both packages."""
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.tensor(v) for k, v in d.items()})


def _exact_operands(rng, shape):
    """Operands whose Chan merge is exact in f32: equal power-of-two counts,
    integer means of one parity (so delta is even), integer M2."""
    n = np.broadcast_to(2.0 ** rng.integers(0, 5, shape[:1])[:, None],
                        shape).astype(np.float32)
    parity = rng.integers(0, 2, shape)
    ma = (2 * rng.integers(-50, 50, shape) + parity).astype(np.float32)
    mb = (2 * rng.integers(-50, 50, shape) + parity).astype(np.float32)
    a = {"n": n, "mean": ma,
         "m2": rng.integers(0, 100, shape).astype(np.float32)}
    b = {"n": n.copy(), "mean": mb,
         "m2": rng.integers(0, 100, shape).astype(np.float32)}
    return a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_subtract_bitwise_on_exact_streams(seed):
    rng = np.random.default_rng(seed)
    a, b = _exact_operands(rng, (16, 8))
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    jm, tm = jstats.merge(ja, jb), tstats.merge(ta, tb)
    for k in ("n", "mean", "m2"):
        np.testing.assert_array_equal(np.asarray(jm[k]), tm[k].numpy(), k)
    js, ts = jstats.subtract(jm, jb), tstats.subtract(tm, tb)
    for k in ("n", "mean", "m2"):
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), k)
        # subtraction recovers the left operand exactly
        np.testing.assert_array_equal(ts[k].numpy(), a[k], k)


def test_merge_identity_and_empty_operands():
    rng = np.random.default_rng(3)
    d = {"n": rng.integers(0, 3, 32).astype(np.float32),
         "mean": rng.normal(0, 1, 32).astype(np.float32),
         "m2": rng.uniform(0, 2, 32).astype(np.float32)}
    d["mean"][d["n"] == 0] = 0.0
    d["m2"][d["n"] == 0] = 0.0
    _, t = _pair(d)
    m = tstats.merge(t, tstats.init((32,)))
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(m[k].numpy(), d[k], rtol=1e-6, atol=0)
    e = tstats.merge(tstats.init((4,)), tstats.init((4,)))
    assert all(float(v.abs().max()) == 0.0 for v in e.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_streams_within_tolerance(seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(3.0, 2.0, (64, 40)).astype(np.float32)
    w = rng.uniform(0.0, 3.0, (64, 40)).astype(np.float32)
    for ww in (None, w):
        jb = jstats.from_batch(jnp.asarray(y), None if ww is None
                               else jnp.asarray(ww), axis=1)
        tb = tstats.from_batch(torch.as_tensor(y), None if ww is None
                               else torch.as_tensor(ww), dim=1)
        for k in ("n", "mean", "m2"):
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       rtol=TOL, atol=TOL)
    # Welford observe, then merge/subtract of two halves
    js, ts = jstats.init((64,)), tstats.init((64,))
    for j in range(40):
        js = jstats.observe(js, jnp.asarray(y[:, j]), jnp.asarray(w[:, j]))
        ts = tstats.observe(ts, torch.as_tensor(y[:, j]),
                            torch.as_tensor(w[:, j]))
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=TOL, atol=TOL)
    ja, ta = _pair({k: np.asarray(v) for k, v in
                    jstats.from_batch(jnp.asarray(y[:, :25]), axis=1).items()})
    jb, tb = _pair({k: np.asarray(v) for k, v in
                    jstats.from_batch(jnp.asarray(y[:, 25:]), axis=1).items()})
    jm, tm = jstats.merge(ja, jb), tstats.merge(ta, tb)
    jsub, tsub = jstats.subtract(jm, jb), tstats.subtract(tm, tb)
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tsub[k].numpy(), np.asarray(jsub[k]),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tstats.variance(tm).numpy(),
                               np.asarray(jstats.variance(jm)),
                               rtol=TOL, atol=TOL)
