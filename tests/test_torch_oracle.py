"""The seed engine (``split_backend="oracle"``) and the full-scan query
(``compact_query=False``) of the port.

* The port's oracle tree against the reference's oracle tree on the same
  numpy stream, batch by batch: topology exact, statistics within 1e-4
  (tables and the capacity case included: the oracle has no capacity gate
  before its query).
* The port's oracle forest against the reference's, with the reference's
  random draws injected (ROADMAP C3).
* The port's oracle against its own kernel engine (``auto``; the plain
  versions here): the same node counts and the MSE within 1 %, the
  reference's own criterion (``tests/test_forest.py``).
* ``compact_query=False`` gives trees bitwise equal to ``True`` (the
  port's counterpart of ``tests/test_attempt_compaction.py``).
* The data-parallel builders and the engine configuration refuse what the
  port does not take.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forest as jfr
from repro.core import hoeffding as jht
from repro_torch import convert
from repro_torch.core import engine as teng
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.data import synth
from repro_torch.kernels import ref as kref
from repro_torch.train import sharding as tsh

TOL = 1e-4
TOPOLOGY = ("feature", "child", "is_leaf", "depth", "n_nodes")
TREE_KW = dict(n_features=4, max_nodes=63, n_bins=32, grace_period=100,
               max_depth=6, r0=0.25)


def parent_scale(tree, key):
    """Per node, |the parent's ystats[key]| (0 at the root): the oracle
    engine recovers a right child's statistics by the subtraction of Eqs.
    6-7 from the parent's table total, so their rounding follows the
    parent's magnitude, not the child's."""
    scale = np.zeros(tree["child"].shape[0], np.float64)
    for p in np.nonzero(~tree["is_leaf"] & (tree["child"][:, 0] >= 0))[0]:
        scale[tree["child"][p]] = abs(float(tree["ystats"][key][p])) \
            * max(float(tree["ystats"]["n"][p]), 1.0)
    return scale


def assert_tree_holds(ref, port, where=""):
    """ref: a JAX tree state; port: the port's, as numpy.  Topology exact;
    every float within 1e-4 relative and absolute, a node's target mean
    and M2 relative to its parent's too (see :func:`parent_scale`)."""
    for k in TOPOLOGY:
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]),
                                      err_msg=f"{where}{k}")
    for k in ("threshold", "ao_radius", "ao_origin", "seen_since_attempt",
              "dec_logE", "ao_sum_x"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}{k}")
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(port["ao_y"][k], np.asarray(ref["ao_y"][k]),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{where}ao_y.{k}")
        got, want = port["ystats"][k], np.asarray(ref["ystats"][k])
        scale = parent_scale(port, k) if k != "n" else 0.0
        bad = np.abs(got - want) > TOL * (np.abs(want) + scale) + TOL
        assert not bad.any(), (f"{where}ystats.{k} at {np.nonzero(bad)[0]}: "
                               f"{got[bad]} vs {want[bad]}")


@pytest.mark.parametrize("schedule,decision,max_nodes", [
    ("grace", "hoeffding", 63), ("eager", "anytime", 63),
    ("grace", "hoeffding", 7)])
def test_oracle_tree_matches_reference_oracle(schedule, decision, max_nodes):
    kw = dict(TREE_KW, attempt_schedule=schedule, decision_backend=decision,
              max_nodes=max_nodes, split_backend="oracle")
    jc, tc = jht.HTRConfig(**kw), tht.HTRConfig(**kw)
    jupd = jax.jit(functools.partial(jht.update, jc))
    js = jht.init_state(jc)
    ts = tht.init_state(tc, device="cpu")
    X, y = synth.piecewise_regression(3000, 4, seed=5)
    X[7, 1] = np.nan
    for i in range(0, 3000, 250):
        js = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
        ts = tht.update(tc, ts, X[i:i + 250], y[i:i + 250], device="cpu")
        assert_tree_holds(js, convert.state_to_numpy(ts), f"batch {i}: ")
    assert int(ts["n_nodes"]) > 1, "the tree never split"
    Xt, _ = synth.piecewise_regression(200, 4, seed=6)
    np.testing.assert_allclose(
        tht.predict(tc, ts, Xt, device="cpu").numpy(),
        np.asarray(jht.predict(jc, js, jnp.asarray(Xt))), rtol=TOL, atol=TOL)


def reference_draws(cfg, state, B):
    """The bagging weights and subspace masks ``repro.core.forest.update``
    draws from ``state["keys"]`` for a batch of B rows."""
    split = jax.vmap(functools.partial(jax.random.split, num=3))(
        state["keys"])
    cdf = jnp.asarray(jfr._poisson_cdf(cfg.lam), jnp.float32)
    bag_w = jax.vmap(lambda k: jfr._poisson_weights(k, cdf, (B,)))(
        split[:, 1])
    masks = jax.vmap(functools.partial(
        jfr._draw_mask, F=cfg.tree.n_features, k=cfg.subspace_k()))(
        split[:, 2])
    return np.array(bag_w), np.array(masks)


def test_oracle_forest_matches_reference_oracle():
    kw = dict(TREE_KW, split_backend="oracle")
    jc = jfr.ForestConfig(tree=jht.HTRConfig(**kw), n_trees=3)
    tc = tfr.ForestConfig(tree=tht.HTRConfig(**kw), n_trees=3)
    js = jfr.init_forest(jc, jax.random.PRNGKey(0))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(2000, 4, seed=11)
    for i in range(0, 2000, 250):
        bag_w, masks = reference_draws(jc, js, 250)
        js, ja = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
        ts, ta = tfr.update(tc, ts, X[i:i + 250], y[i:i + 250], bag_w=bag_w,
                            new_masks=masks, device="cpu")
        port = convert.state_to_numpy(ts)
        for t in range(3):
            assert_tree_holds(jax.tree.map(lambda a: a[t], js["trees"]),
                              jax.tree.map(lambda a: a[t], port["trees"]),
                              f"batch {i} tree {t}: ")
        np.testing.assert_allclose(ta["forest_mse"].numpy(),
                                   np.asarray(ja["forest_mse"]), rtol=TOL,
                                   atol=TOL)
    assert (np.asarray(js["trees"]["n_nodes"]) > 1).all()


def _mse(pred, y):
    return float(((pred - torch.as_tensor(y)) ** 2).mean())


def test_oracle_tree_matches_the_kernel_engine():
    X, y = synth.piecewise_regression(4000, 4, seed=7)
    Xt, yt = synth.piecewise_regression(1000, 4, seed=8)
    out = {}
    for backend in ("auto", "oracle"):
        cfg = tht.HTRConfig(split_backend=backend, **TREE_KW)
        st = tht.update_stream(cfg, tht.init_state(cfg, device="cpu"), X, y,
                               batch_size=250, device="cpu")
        out[backend] = (int(st["n_nodes"]),
                        _mse(tht.predict(cfg, st, Xt, device="cpu"), yt))
    assert out["oracle"][0] == out["auto"][0] > 1
    assert abs(out["oracle"][1] - out["auto"][1]) <= 0.01 * out["auto"][1]


def test_oracle_forest_matches_the_kernel_engine():
    T, B = 4, 256
    X, y = synth.piecewise_regression(12 * B, 4, seed=9)
    rng = np.random.default_rng(9)
    bag = rng.poisson(6.0, (12, T, B)).astype(np.float32)
    masks = np.ones((T, 4), bool)
    out = {}
    for backend in ("auto", "oracle"):
        cfg = tfr.ForestConfig(tree=tht.HTRConfig(split_backend=backend,
                                                  **TREE_KW), n_trees=T)
        st = tfr.init_forest(cfg, 0, device="cpu", feat_mask=masks)
        mse = []
        for i in range(12):
            st, aux = tfr.update(cfg, st, X[i * B:(i + 1) * B],
                                 y[i * B:(i + 1) * B], bag_w=bag[i],
                                 new_masks=masks, device="cpu")
            mse.append(float(aux["forest_mse"]))
        out[backend] = (st["trees"]["n_nodes"].tolist(), np.mean(mse[4:]))
    assert out["oracle"][0] == out["auto"][0]
    assert min(out["auto"][0]) > 1
    assert abs(out["oracle"][1] - out["auto"][1]) <= 0.01 * out["auto"][1]


def test_forest_route_ref_is_the_kernel_route():
    """The oracle's per-member scalar walk gives the route's ids."""
    from repro_torch.kernels import qo_route
    cfg = tfr.ForestConfig(tree=tht.HTRConfig(**TREE_KW), n_trees=3)
    st = tfr.init_forest(cfg, 0, device="cpu")
    X, y = synth.piecewise_regression(2000, 4, seed=3)
    for i in range(0, 2000, 500):
        st, _ = tfr.update(cfg, st, X[i:i + 500], y[i:i + 500], device="cpu")
    tr = st["trees"]
    Xq = torch.as_tensor(X[:300])
    Xq[0, :] = float("nan")
    arrays = [tr[k] for k in ("feature", "threshold", "child", "is_leaf")]
    assert torch.equal(kref.forest_route_ref(*arrays, Xq, 6),
                       qo_route.route_plain(*arrays, Xq, 6))


@pytest.mark.parametrize("observer", ["qo", "sketch"])
def test_full_scan_query_is_bitwise_the_compacted_one(observer):
    X, y = synth.piecewise_regression(3000, 4, seed=4)
    states = {}
    for compact in (True, False):
        cfg = tfr.ForestConfig(tree=tht.HTRConfig(
            compact_query=compact, observer_backend=observer, **TREE_KW),
            n_trees=3)
        st = tfr.init_forest(cfg, 0, device="cpu")
        trace = []
        for i in range(0, 3000, 250):
            st, aux = tfr.update(cfg, st, X[i:i + 250], y[i:i + 250],
                                 device="cpu")
            trace.append(convert.state_to_numpy(st)["trees"])
        states[compact] = trace
    for a, b in zip(states[True], states[False]):
        for k, v in a.items():
            pairs = zip(v.values(), b[k].values()) if isinstance(v, dict) \
                else [(v, b[k])]
            for u, w in pairs:
                np.testing.assert_array_equal(u, w, err_msg=k)
    assert (states[True][-1]["n_nodes"] > 1).all()


def test_dp_builders_refuse_the_oracle(tmp_path):
    import datetime
    import torch.distributed as dist
    cfg = tfr.ForestConfig(tree=tht.HTRConfig(split_backend="oracle",
                                              **TREE_KW), n_trees=2)
    with pytest.raises(ValueError, match="oracle"):
        tsh.build_data_parallel_reference(cfg, 2, device="cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        with pytest.raises(ValueError, match="oracle"):
            tsh.build_data_parallel_forest(cfg, device="cpu")
    finally:
        dist.destroy_process_group()


def test_engine_config_backend():
    assert teng.EngineConfig(backend=None).backend is None
    for backend in ("jnp", "pallas", "cuda"):
        with pytest.raises(ValueError, match="None"):
            teng.EngineConfig(backend=backend)
