"""Port parity: the multi-target QO (``repro_torch.core.multi``) against
the JAX package's ``repro.core.multi`` on the same numpy inputs.

Counts and bin ids exact (the C1 inputs 1e10, +inf and NaN included);
per-bin statistics, merit and threshold within 1e-4 (the reference's
``associative_scan`` and the port's log-step scan combine the bins in
different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multi as rmulti
from repro.core import qo as rqo
from repro_torch.core import multi as tmulti
from repro_torch.core import qo as tqo

TOL = 1e-4


def batch(rng, n, T, extremes=False):
    x = rng.normal(0, 1, n).astype(np.float32)
    if extremes:
        x[:6] = [1e10, np.inf, np.nan, -1e10, -np.inf, np.nan]
    Y = np.stack([np.where(np.nan_to_num(x) <= 0.2 * t, 1.0 + t, -t)
                  + 0.1 * (t + 1) * rng.normal(0, 1, n)
                  for t in range(T)], 1).astype(np.float32)
    return x, Y


def both(C, T, radius, origin, batches):
    r = rmulti.init(C, T, radius, origin)
    t = tmulti.init(C, T, radius, origin, device="cpu")
    upd = jax.jit(rmulti.update)
    for x, Y in batches:
        r = upd(r, jnp.asarray(x), jnp.asarray(Y))
        t = tmulti.update(t, x, Y, device="cpu")
    return r, t


def assert_tables_close(r, t):
    np.testing.assert_array_equal(t["y"]["n"].numpy(), np.asarray(r["y"]["n"]))
    for k in ("mean", "m2"):
        np.testing.assert_allclose(t["y"][k].numpy(), np.asarray(r["y"][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(t["sum_x"].numpy(), np.asarray(r["sum_x"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("C", [16, 64])
@pytest.mark.parametrize("T", [1, 3])
def test_matches_reference(C, T):
    rng = np.random.default_rng(C * 10 + T)
    batches = [batch(rng, 500, T) for _ in range(3)]
    r, t = both(C, T, 0.25, 0.1, batches)
    assert_tables_close(r, t)
    rs = jax.jit(rmulti.best_split)(r)
    ts = tmulti.best_split(t, device="cpu")
    assert bool(ts.valid) == bool(rs.valid)
    np.testing.assert_allclose(float(ts.merit), float(rs.merit), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(ts.threshold), float(rs.threshold),
                               rtol=TOL, atol=TOL)
    assert int(tmulti.n_slots(t)) == int(rmulti.n_slots(r))


@pytest.mark.parametrize("C", [16, 64])
def test_extreme_x_bins_exactly(C):
    """ROADMAP C1: with radius 1 and origin 0, 1e10 and +inf land in bin 0
    (saturating cast, then the int32 wrap), NaN in bin C/2; the port's
    counts equal the reference's bin for bin."""
    rng = np.random.default_rng(C)
    x, Y = batch(rng, 64, 3, extremes=True)
    r, t = both(C, 3, 1.0, 0.0, [(x, Y)])
    assert_tables_close(r, t)
    n = t["y"]["n"][:, 0]
    assert float(n[0]) >= 2 and float(n[C // 2]) >= 2


def test_one_target_reduces_to_the_single_target_qo():
    """T = 1: the normalized VR is the QO's VR over the target's variance;
    same threshold, merit scaled by the variance, same slots."""
    rng = np.random.default_rng(3)
    x, Y = batch(rng, 800, 1)
    t = tmulti.update(tmulti.init(32, 1, 0.2, device="cpu"), x, Y,
                      device="cpu")
    q = tqo.update(tqo.init(32, 0.2, device="cpu"), x, Y[:, 0],
                   device="cpu")
    ms, qs = tmulti.best_split(t, device="cpu"), tqo.best_split(
        q, device="cpu")
    var = float(np.var(Y[:, 0], ddof=1))
    np.testing.assert_allclose(float(ms.threshold), float(qs.threshold),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ms.merit) * var, float(qs.merit),
                               rtol=1e-3)
    assert int(tmulti.n_slots(t)) == int(tqo.n_slots(q))
    rq = jax.jit(rqo.update)(rqo.init(32, 0.2), jnp.asarray(x),
                             jnp.asarray(Y[:, 0]))
    np.testing.assert_allclose(float(qs.threshold),
                               float(jax.jit(rqo.best_split)(rq).threshold),
                               rtol=TOL, atol=TOL)


def test_out_of_place_and_device():
    t = tmulti.init(8, 2, 0.5, device="cpu")
    x, Y = batch(np.random.default_rng(0), 10, 2)
    u = tmulti.update(t, x, Y, device="cpu")
    assert float(t["y"]["n"].sum()) == 0 and float(u["y"]["n"][:, 0].sum()) == 10
    with pytest.raises(ValueError, match="lives on cpu"):
        tmulti.update(t, x, Y, device="meta")
