"""Port parity end to end: the tree, the forest and snapshot serving.

The same numpy streams go through the JAX package (``backend="jnp"``,
jitted) and the port (``device="cpu"``, the kernels' plain versions).
After every batch the topology (``feature``, ``child``, ``is_leaf``,
``depth``, ``n_nodes``) must be identical; thresholds, target stats,
forest MSE and vote weights within 1e-4.  The forest's random draws are
taken from the JAX state's keys and injected into the port (ROADMAP C3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forest as jfr
from repro.core import hoeffding as jht
from repro.core import serve as jsv
from repro_torch import convert
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import serve as tsv
from repro_torch.data import synth

TOL = 1e-4
TOPOLOGY = ("feature", "child", "is_leaf", "depth", "n_nodes")
TREE_KW = dict(n_features=4, max_nodes=63, n_bins=32, grace_period=100,
               max_depth=6, r0=0.25)


def assert_tree_holds(ref, port, where=""):
    """ref: a JAX tree state; port: the port's, as numpy."""
    for k in TOPOLOGY:
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]),
                                      err_msg=f"{where}{k}")
    np.testing.assert_allclose(port["threshold"], np.asarray(ref["threshold"]),
                               rtol=TOL, atol=TOL, err_msg=f"{where}thr")
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(port["ystats"][k],
                                   np.asarray(ref["ystats"][k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}ystats.{k}")
        np.testing.assert_allclose(port["ao_y"][k],
                                   np.asarray(ref["ao_y"][k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}ao_y.{k}")
    for k in ("ao_radius", "ao_origin", "seen_since_attempt", "dec_logE"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}{k}")


def test_synth_stream_is_the_reference_stream():
    from repro.data import synth as jsynth
    for a, b in zip(synth.piecewise_regression(300, 5, seed=3),
                    jsynth.piecewise_regression(300, 5, seed=3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule,decision", [
    ("grace", "hoeffding"), ("eager", "hoeffding"), ("eager", "anytime")])
def test_tree_update_matches_reference(schedule, decision):
    kw = dict(TREE_KW, attempt_schedule=schedule, decision_backend=decision)
    jc = jht.HTRConfig(split_backend="jnp", **kw)
    tc = tht.HTRConfig(**kw)
    jupd = jax.jit(functools.partial(jht.update, jc))
    js = jht.init_state(jc)
    ts = tht.init_state(tc, device="cpu")
    X, y = synth.piecewise_regression(3000, 4, seed=5)
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


def forest_pair(T=4, **kw):
    jc = jfr.ForestConfig(tree=jht.HTRConfig(split_backend="jnp", **TREE_KW),
                          n_trees=T, **kw)
    tc = tfr.ForestConfig(tree=tht.HTRConfig(**TREE_KW), n_trees=T, **kw)
    js = jfr.init_forest(jc, jax.random.PRNGKey(0))
    return jc, tc, js


def learn_both(jc, tc, js, ts, X, y, jupd, batch=250, w=None):
    """Learn X, y batch by batch in both packages; check after each."""
    for i in range(0, len(y), batch):
        sl = slice(i, i + batch)
        wb = None if w is None else w[sl]
        bag_w, masks = reference_draws(jc, js, len(y[sl]))
        js, ja = jupd(js, jnp.asarray(X[sl]), jnp.asarray(y[sl]),
                      w=None if wb is None else jnp.asarray(wb))
        ts, ta = tfr.update(tc, ts, X[sl], y[sl], wb, bag_w=bag_w,
                            new_masks=masks, device="cpu")
        port = convert.state_to_numpy(ts)
        for t in range(tc.n_trees):
            assert_tree_holds(jax.tree.map(lambda a: a[t], js["trees"]),
                              jax.tree.map(lambda a: a[t], port["trees"]),
                              f"batch {i} tree {t}: ")
        np.testing.assert_array_equal(port["feat_mask"],
                                      np.asarray(js["feat_mask"]))
        for k in ("forest_mse", "member_mse"):
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_array_equal(ta["drift"].numpy(),
                                      np.asarray(ja["drift"]))
        np.testing.assert_allclose(port["vote_w"], np.asarray(js["vote_w"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(port["err_ewma"],
                                   np.asarray(js["err_ewma"]), rtol=TOL,
                                   atol=TOL)
    return js, ts


def test_forest_update_matches_reference_with_injected_draws():
    jc, tc, js = forest_pair()
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(3000, 4, seed=11)
    # a ragged, partly masked tail batch rides at the end
    w = np.ones(len(y), np.float32)
    w[-90:] = 0.0
    js, ts = learn_both(jc, tc, js, ts, X, y, jupd, w=w)
    assert (np.asarray(js["trees"]["n_nodes"]) > 1).all()
    Xt, _ = synth.piecewise_regression(300, 4, seed=12)
    np.testing.assert_allclose(
        tfr.predict(tc, ts, Xt, device="cpu").numpy(),
        np.asarray(jfr.predict(jc, js, jnp.asarray(Xt))), rtol=TOL, atol=TOL)


def test_forest_drift_swap_matches_reference():
    """An abrupt concept shift fires the drift test and swaps a member in
    both packages on the same batch."""
    jc, tc, js = forest_pair(T=3, drift_min_batches=2, drift_decay=0.6)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(4000, 4, seed=13)
    y[2000:] = (synth.piecewise_target(X[2000:], shift=1.0) + 20.0
                ).astype(np.float32)
    js, ts = learn_both(jc, tc, js, ts, X, y, jupd)
    assert int(np.asarray(js["resets"]).sum()) > 0, "no drift swap fired"
    np.testing.assert_array_equal(ts["resets"].numpy(),
                                  np.asarray(js["resets"]))


def test_state_carried_over_learns_the_next_batch_alike():
    """Train 4 batches in JAX, carry the state into the port, learn batch 5
    in both packages and compare."""
    jc, tc, js = forest_pair()
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(1250, 4, seed=21)
    for i in range(0, 1000, 250):
        js, _ = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    back = convert.state_to_numpy(ts)
    assert "rng" in ts and "keys" not in ts and "keys" not in back
    for t in range(tc.n_trees):
        assert_tree_holds(jax.tree.map(lambda a: a[t], js["trees"]),
                          jax.tree.map(lambda a: a[t], back["trees"]))
    learn_both(jc, tc, js, ts, X[1000:], y[1000:], jupd)


def test_freeze_and_serve_match_reference():
    """Snapshots of one carried-over state are array-for-array identical
    in both packages; the port's snapshot serves its live predictions bit
    for bit, and the reference's within tolerance."""
    jc, tc, js = forest_pair()
    jupd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(2000, 4, seed=31)
    for i in range(0, 2000, 250):
        js, _ = jupd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    snaps = {"forest": (jsv.freeze(js), tsv.freeze(ts, device="cpu")),
             "tree": (jsv.freeze(jax.tree.map(lambda a: a[0], js["trees"])),
                      tsv.freeze({k: (v[0] if torch.is_tensor(v) else
                                      {kk: vv[0] for kk, vv in v.items()})
                                  for k, v in ts["trees"].items()},
                                 device="cpu"))}
    Xt, _ = synth.piecewise_regression(300, 4, seed=32)
    Xt[0] = np.nan
    for name, (jsnap, tsnap) in snaps.items():
        arrays = convert.snapshot_to_numpy(tsnap)
        for k, v in arrays.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(jsnap, k)),
                                          err_msg=f"{name}:{k}")
        assert (tsnap.depth, tsnap.single) == (jsnap.depth, jsnap.single)
        np.testing.assert_allclose(
            tsv.predict_snapshot(tsnap, Xt, device="cpu").numpy(),
            np.asarray(jsv.predict_snapshot(jsnap, jnp.asarray(Xt))),
            rtol=TOL, atol=TOL)
        again = convert.snapshot_from_numpy(arrays, depth=tsnap.depth,
                                            single=tsnap.single,
                                            device="cpu")
        assert torch.equal(tsv.predict_snapshot(again, Xt, device="cpu"),
                           tsv.predict_snapshot(tsnap, Xt, device="cpu"))
    assert torch.equal(
        tsv.predict_snapshot(snaps["forest"][1], Xt, device="cpu"),
        tfr.predict(tc, ts, Xt, device="cpu"))
    tree = {k: (v[0] if torch.is_tensor(v) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in ts["trees"].items()}
    assert torch.equal(
        tsv.predict_snapshot(snaps["tree"][1], Xt, device="cpu"),
        tht.predict(tc.tree, tree, Xt, device="cpu"))


def test_port_draws_repeat_and_update_stream_is_the_loop():
    """Without injected draws the port draws from the state's generator:
    the same state gives the same step, and the bagging weights have the
    Poisson(lambda) mean."""
    tc = tfr.ForestConfig(tree=tht.HTRConfig(**TREE_KW), n_trees=4)
    X, y = synth.piecewise_regression(500, 4, seed=41)
    a = tfr.init_forest(tc, 5, device="cpu")
    b = tfr.init_forest(tc, 5, device="cpu")
    assert torch.equal(a["feat_mask"], b["feat_mask"])
    assert (a["feat_mask"].sum(1) == tc.subspace_k()).all()
    for i in range(0, 500, 250):
        a, _ = tfr.update(tc, a, X[i:i + 250], y[i:i + 250], device="cpu")
        b, _ = tfr.update(tc, b, X[i:i + 250], y[i:i + 250], device="cpu")
    for k in ("n", "mean", "m2"):
        assert torch.equal(a["trees"]["ystats"][k], b["trees"]["ystats"][k])
    # update_stream is the same loop, the ragged tail at weight 0
    c = tfr.init_forest(tc, 5, device="cpu")
    d = tfr.init_forest(tc, 5, device="cpu")
    c, trace = tfr.update_stream(tc, c, X[:450], y[:450], batch_size=200,
                                 device="cpu")
    w = np.zeros(600, np.float32)
    w[:450] = 1.0
    Xp = np.concatenate([X[:450], np.zeros((150, 4), np.float32)])
    yp = np.concatenate([y[:450], np.zeros(150, np.float32)])
    for i in range(0, 600, 200):
        d, aux = tfr.update(tc, d, Xp[i:i + 200], yp[i:i + 200],
                            w[i:i + 200], device="cpu")
    assert trace["forest_mse"].shape == (3,)
    assert trace["member_mse"].shape == (3, 4)
    assert float(trace["forest_mse"][-1]) == float(aux["forest_mse"])
    assert torch.equal(c["trees"]["ao_y"]["m2"], d["trees"]["ao_y"]["m2"])
    gen = torch.Generator().manual_seed(0)
    cdf = torch.tensor(tfr._poisson_cdf(6.0), dtype=torch.float32)
    draws = tfr._poisson_weights(gen, cdf, (20000,), torch.device("cpu"))
    assert abs(float(draws.mean()) - 6.0) < 0.1
