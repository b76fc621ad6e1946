"""Port parity: data-parallel stream training (the reference's
``train/sharding.py`` DP half, DESIGN.md §4.1).

* The port's ``build_data_parallel_reference`` (``device="cpu"``: the
  plain versions) is held against the JAX package's, on the same numpy
  streams, with the JAX initial state carried over
  (``convert.dp_state_from_numpy``) and the JAX shards' bagging draws
  injected (ROADMAP C3).  At every sync boundary the topology
  (``feature``, ``child``, ``is_leaf``, ``depth``, ``n_nodes``) must be
  identical and the f32 state and ``aux`` within 1e-4; between syncs the
  port's forest must be untouched and its deltas within 1e-4 of the
  reference's.  Both observers; D in {1, 3, 4}; ``sync_every`` in {1, 2};
  ``update_window``.
* ``build_data_parallel_forest`` over gloo with 2 and 4 ranks (spawned
  processes, each run bounded by its own timeouts) is held BITWISE
  against the port's reference at every sync; its int8 path keeps the
  merged mass within 5 % of exact, and at every int8 sync the merged
  delta equals the reference's ``_dp_gather_int8`` bitwise and the
  applied forest its ``_dp_apply_sync`` within 1e-4;
  ``compress.quantized_all_reduce`` equals the reference's
  ``quantized_psum`` under ``jax.vmap``.  int8 with the sketch observer
  is refused (ROADMAP C9).
"""
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import forest as jfr
from repro.core import hoeffding as jht
from repro.optim import compress as jcompress
from repro.train import sharding as jsh
from repro_torch import convert
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.data import synth
from repro_torch.optim import compress as tcompress
from repro_torch.train import sharding as tsh
from tests.test_torch_forest import assert_tree_holds

TOL = 1e-4
T = 4
TREE_KW = dict(n_features=4, max_nodes=31, n_bins=32, grace_period=100,
               max_depth=6, r0=0.25)


def configs(observer="qo"):
    kw = dict(TREE_KW, observer_backend=observer)
    return (jfr.ForestConfig(tree=jht.HTRConfig(split_backend="jnp", **kw),
                             n_trees=T),
            tfr.ForestConfig(tree=tht.HTRConfig(**kw), n_trees=T))


@functools.lru_cache(maxsize=None)
def _draw_fn(lam: float, b: int):
    """keys (D, T, 2) -> (the (D, T, b) bagging weights the reference's
    local step draws, the keys it carries on)."""
    cdf = jnp.asarray(jfr._poisson_cdf(lam), jnp.float32)

    def shard(k):
        split = jax.vmap(functools.partial(jax.random.split, num=2))(k)
        w = jax.vmap(lambda kk: jfr._poisson_weights(kk, cdf, (b,)))(
            split[:, 1])
        return w, split[:, 0]

    return jax.jit(jax.vmap(shard))


def reference_dp_draws(jc, keys, b, steps=1):
    """(steps, D, T, b) weights of ``steps`` successive local steps."""
    out = []
    for _ in range(steps):
        w, keys = _draw_fn(jc.lam, b)(keys)
        out.append(np.asarray(w))
    return np.stack(out)


def assert_forest_holds(ref, port, where=""):
    """ref: a JAX forest state; port: the port's, as numpy."""
    for t in range(T):
        rt = jax.tree.map(lambda a: a[t], ref["trees"])
        pt = jax.tree.map(lambda a: a[t], port["trees"])
        assert_tree_holds(rt, pt, f"{where}tree {t}: ")
        np.testing.assert_allclose(pt["ao_sum_x"], np.asarray(rt["ao_sum_x"]),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{where}tree {t}: ao_sum_x")
    np.testing.assert_array_equal(port["feat_mask"],
                                  np.asarray(ref["feat_mask"]))
    for k in ("vote_w", "err_ewma"):
        np.testing.assert_allclose(port[k], np.asarray(ref[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}{k}")
    for k in ("n", "mean", "m2"):
        np.testing.assert_allclose(port["err_win"][k],
                                   np.asarray(ref["err_win"][k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{where}err_win.{k}")


def assert_close_tree(port, ref, where=""):
    jax.tree.map(lambda p, r: np.testing.assert_allclose(
        p, np.asarray(r), rtol=TOL, atol=TOL, err_msg=where), port, ref)


def assert_bitwise(a, b, where=""):
    if isinstance(a, dict):
        for k in a:
            assert_bitwise(a[k], b[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def stream(D, n_batches, seed):
    B = 384 if D == 3 else 256
    X, y = synth.piecewise_regression(B * n_batches, 4, seed=seed)
    return X.reshape(n_batches, B, 4), y.reshape(n_batches, B)


@pytest.mark.parametrize("observer,D,sync_every", [
    ("qo", 1, 1), ("qo", 3, 2), ("qo", 4, 2), ("sketch", 3, 1),
    ("sketch", 4, 2)])
def test_reference_matches_jax_at_every_sync(observer, D, sync_every):
    jc, tc = configs(observer)
    ji, ju, _, jp = jsh.build_data_parallel_reference(jc, D, sync_every)
    _, tu, _, tp = tsh.build_data_parallel_reference(tc, D, sync_every,
                                                     device="cpu")
    js = ji(jax.random.PRNGKey(5))
    ts = convert.dp_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    Xs, ys = stream(D, 8, seed=7)
    b = ys.shape[1] // D
    syncs = 0
    for i, (X, y) in enumerate(zip(Xs, ys)):
        bag_w = reference_dp_draws(jc, js["keys"], b)[0]
        before = convert.state_to_numpy(ts["forest"])
        js, ja = ju(js, jnp.asarray(X), jnp.asarray(y))
        ts, ta = tu(ts, X, y, bag_w=bag_w)
        assert (ja is None) == (ta is None) and ts["step"] == js["step"]
        port = convert.dp_state_to_numpy(ts)
        if ta is None:
            assert_bitwise(port["forest"], before, f"batch {i} forest")
            assert_close_tree(port["delta"], js["delta"], f"batch {i} delta")
            continue
        syncs += 1
        assert_forest_holds(js["forest"], port["forest"], f"batch {i}: ")
        np.testing.assert_array_equal(ta["n_nodes"].numpy(),
                                      np.asarray(ja["n_nodes"]))
        for k in ("mass", "member_mse"):
            np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        # the delta is back at the merge identity
        assert all(not np.any(v) for v in jax.tree.leaves(port["delta"]))
    assert syncs == 8 // sync_every
    assert (port["forest"]["trees"]["n_nodes"] > 1).all()
    Xt, _ = synth.piecewise_regression(200, 4, seed=8)
    np.testing.assert_allclose(tp(ts, Xt).numpy(),
                               np.asarray(jp(js, jnp.asarray(Xt))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("observer", ["qo", "sketch"])
def test_update_window_matches_jax_and_per_step(observer):
    """A window of S = 2 local steps + sync equals the reference's window
    within 1e-4, and the port's own two ``update`` calls bitwise."""
    D, S = 2, 2
    jc, tc = configs(observer)
    ji, _, jw, _ = jsh.build_data_parallel_reference(jc, D, sync_every=S)
    ti, tu, tw, _ = tsh.build_data_parallel_reference(tc, D, sync_every=S,
                                                      device="cpu")
    js = ji(jax.random.PRNGKey(9))
    tw_state = convert.dp_state_from_numpy(jax.tree.map(np.asarray, js),
                                           "cpu")
    tp_state = convert.dp_state_from_numpy(jax.tree.map(np.asarray, js),
                                           "cpu")
    Xs, ys = stream(D, 8, seed=11)
    b = ys.shape[1] // D
    for i in range(0, 8, S):
        bag_w = reference_dp_draws(jc, js["keys"], b, steps=S)
        js, ja = jw(js, jnp.asarray(Xs[i:i + S]), jnp.asarray(ys[i:i + S]))
        tw_state, ta = tw(tw_state, Xs[i:i + S], ys[i:i + S], bag_w=bag_w)
        for s in range(S):
            tp_state, tpa = tu(tp_state, Xs[i + s], ys[i + s],
                               bag_w=bag_w[s])
        port = convert.dp_state_to_numpy(tw_state)
        assert_forest_holds(js["forest"], port["forest"], f"window {i}: ")
        np.testing.assert_allclose(ta["mass"].numpy(), np.asarray(ja["mass"]),
                                   rtol=TOL, atol=TOL)
        assert tpa is not None and tw_state["step"] == tp_state["step"] \
            == js["step"]
        assert_bitwise(port, convert.dp_state_to_numpy(tp_state),
                       f"window {i}")
    assert (port["forest"]["trees"]["n_nodes"] > 1).all()
    # without injected draws: the same seed repeats, shards differ
    a, b_ = ti(3), ti(3)
    for i in range(2):
        a, _ = tu(a, Xs[i], ys[i])
        b_, _ = tu(b_, Xs[i], ys[i])
    assert_bitwise(convert.dp_state_to_numpy(a), convert.dp_state_to_numpy(b_))
    assert not torch.equal(a["rng"][0], a["rng"][1])


def test_sync_cadence_and_on_sync():
    """Between syncs the forest (grace counters included) is untouched and
    the delta carries the absorbed mass; at the boundary ``on_sync`` sees
    the merged forest and the merged mass lands in the predictors."""
    _, tc = configs()
    seen = []
    ti, tu, _, _ = tsh.build_data_parallel_reference(
        tc, 2, sync_every=3, device="cpu",
        on_sync=lambda forest, step, aux: seen.append((step, aux)))
    st = ti(0)
    seen0 = st["forest"]["trees"]["seen_since_attempt"].clone()
    Xs, ys = stream(2, 3, seed=3)
    st, aux = tu(st, Xs[0], ys[0])
    assert aux is None and not seen
    assert torch.equal(st["forest"]["trees"]["seen_since_attempt"], seen0)
    mass1 = float(st["delta"]["ystats"]["n"].sum())
    assert mass1 > 0
    st, aux = tu(st, Xs[1], ys[1])
    st, aux = tu(st, Xs[2], ys[2])
    assert aux is not None and st["step"] == 3
    assert [s for s, _ in seen] == [3] and seen[0][1] is aux
    assert float(aux["mass"]) > mass1
    assert float(st["delta"]["ystats"]["n"].sum()) == 0.0
    assert float(st["delta"]["ao_y"]["n"].sum()) == 0.0
    assert float(st["forest"]["trees"]["ystats"]["n"].sum()) \
        >= float(aux["mass"]) - 1e-3
    assert int(st["forest"]["trees"]["n_nodes"].max()) > 1
    with pytest.raises(ValueError, match="does not split"):
        tu(st, Xs[0][:255], ys[0][:255])


# --------------------------------------------------------------------------
# torch.distributed over gloo: one spawned process a rank
# --------------------------------------------------------------------------

GLOO_BATCHES, GLOO_SYNC = 8, 2
JOIN_SECONDS = 240


def _gloo_stream(world):
    X, y = synth.piecewise_regression(256 * GLOO_BATCHES, 4, seed=17)
    return X.reshape(GLOO_BATCHES, 256, 4), y.reshape(GLOO_BATCHES, 256)


def _snap(tree):
    """Tensors -> numpy copies (the delta is zeroed in place at a sync)."""
    return jax.tree.map(np.copy, convert.state_to_numpy(tree))


def _rank_main(rank, world, tmp, arrays):
    """One rank: the exact DP run, the int8 DP run and a bare quantized
    all-reduce; every result lands in ``tmp`` as a .pt file."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        _, tc = configs()
        Xs, ys = _gloo_stream(world)
        syncs = []
        i, u, w, _ = tsh.build_data_parallel_forest(
            tc, sync_every=GLOO_SYNC, device="cpu",
            on_sync=lambda f, step, aux: syncs.append(
                (step, convert.state_to_numpy(f),
                 {k: v.numpy().copy() for k, v in aux.items()})))
        st = i(4)
        for X, y in zip(Xs, ys):
            st, _ = u(st, X, y)
        st, _ = w(st, Xs[:2], ys[:2])
        int8, int8_syncs = [], []
        gather_int8, apply_sync = tsh._dp_gather_int8, tsh._dp_apply_sync

        def gather_recorded(delta, group):
            merged = gather_int8(delta, group)
            int8_syncs.append({"delta": _snap(delta), "merged": _snap(merged)})
            return merged

        def apply_recorded(cfg, forest, merged):
            before = _snap(forest)
            out, aux = apply_sync(cfg, forest, merged)
            int8_syncs[-1].update(forest_before=before, forest=_snap(out),
                                  aux=_snap(aux))
            return out, aux

        # record what each int8 sync gathers and applies
        tsh._dp_gather_int8, tsh._dp_apply_sync = gather_recorded, \
            apply_recorded
        try:
            i8, u8, _, p8 = tsh.build_data_parallel_forest(
                tc, sync_every=GLOO_SYNC, compress="int8", device="cpu")
            s8 = i8(4)
            for X, y in zip(Xs, ys):
                s8, aux = u8(s8, X, y)
                if aux is not None:
                    int8.append(float(aux["mass"]))
        finally:
            tsh._dp_gather_int8, tsh._dp_apply_sync = gather_int8, apply_sync
        tree = {"a": torch.tensor(arrays["a"][rank]),
                "b": {"c": torch.tensor(arrays["c"][rank])}}
        summed = tcompress.quantized_all_reduce(tree)
        torch.save({"syncs": syncs,
                    "final_delta": convert.state_to_numpy(st["delta"]),
                    "int8_mass": int8,
                    "int8_syncs": int8_syncs,
                    "int8_nodes": s8["forest"]["trees"]["n_nodes"].numpy(),
                    "int8_pred": p8(s8, Xs[0]).numpy(),
                    "qar": convert.state_to_numpy(summed),
                    "inputs_after": convert.state_to_numpy(tree)},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def gloo_run(request, tmp_path_factory):
    world = request.param
    tmp = str(tmp_path_factory.mktemp(f"gloo{world}"))
    rng = np.random.default_rng(world)
    arrays = {"a": rng.normal(0, 3, (world, 5, 7)).astype(np.float32),
              "c": rng.uniform(-1e-3, 1e-3, (world, 11)).astype(np.float32)}
    arrays["a"][0, 0, 0] = 0.0
    ctx = mp.spawn(_rank_main, args=(world, tmp, arrays), nprocs=world,
                   join=False)
    deadline = JOIN_SECONDS
    try:
        while not ctx.join(timeout=5):
            deadline -= 5
            if deadline <= 0:
                raise AssertionError(f"gloo ranks did not finish within "
                                     f"{JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    return world, arrays, ranks


def test_gloo_forest_bitwise_equals_reference(gloo_run):
    world, _, ranks = gloo_run
    _, tc = configs()
    ref_syncs = []
    i, u, w, _ = tsh.build_data_parallel_reference(
        tc, world, sync_every=GLOO_SYNC, device="cpu",
        on_sync=lambda f, step, aux: ref_syncs.append(
            (step, convert.state_to_numpy(f),
             {k: v.numpy().copy() for k, v in aux.items()})))
    st = i(4)
    Xs, ys = _gloo_stream(world)
    for X, y in zip(Xs, ys):
        st, _ = u(st, X, y)
    st, _ = w(st, Xs[:2], ys[:2])
    assert len(ref_syncs) == GLOO_BATCHES // GLOO_SYNC + 1
    for r, got in enumerate(ranks):
        assert [s for s, _, _ in got["syncs"]] == [s for s, _, _ in ref_syncs]
        for (step, f, aux), (_, rf, raux) in zip(got["syncs"], ref_syncs):
            assert_bitwise(f, rf, f"rank {r} step {step} forest")
            assert_bitwise(aux, raux, f"rank {r} step {step} aux")
        assert_bitwise(got["final_delta"],
                       jax.tree.map(lambda a: a[r:r + 1],
                                    convert.state_to_numpy(st["delta"])),
                       f"rank {r} delta")
    assert (ref_syncs[-1][1]["trees"]["n_nodes"] > 1).all()


def test_gloo_int8_keeps_the_mass(gloo_run):
    world, _, ranks = gloo_run
    _, tc = configs()
    i, u, _, _ = tsh.build_data_parallel_reference(
        tc, world, sync_every=GLOO_SYNC, device="cpu")
    st, exact = i(4), []
    for X, y in zip(*_gloo_stream(world)):
        st, aux = u(st, X, y)
        if aux is not None:
            exact.append(float(aux["mass"]))
    for got in ranks:
        np.testing.assert_allclose(got["int8_mass"], exact, rtol=0.05)
        assert (got["int8_nodes"] > 1).any()
        assert np.isfinite(got["int8_pred"]).all()
        assert_bitwise(got["int8_nodes"], ranks[0]["int8_nodes"])


def test_gloo_int8_sync_matches_reference(gloo_run):
    """Every int8 sync of every rank: the merged delta equals, bitwise,
    the reference's ``_dp_gather_int8`` under an eager ``jax.vmap`` on the
    ranks' deltas (op by op, each rounded alone as in PyTorch; under
    ``jax.jit`` XLA contracts ``m2 + s1*mean`` and a quantum can flip),
    and the forest after the apply equals the reference's
    ``_dp_apply_sync`` of that merged delta on the same forest."""
    world, _, ranks = gloo_run
    jc, _ = configs()
    gather = jax.vmap(lambda d: jsh._dp_gather_int8(jc, d, "d"),
                      axis_name="d")
    apply = jsh._dp_apply_jit(jc)
    n_syncs = GLOO_BATCHES // GLOO_SYNC
    for got in ranks:
        assert len(got["int8_syncs"]) == n_syncs
    for s in range(n_syncs):
        merged = gather(jax.tree.map(
            lambda *a: jnp.stack(a),
            *[got["int8_syncs"][s]["delta"] for got in ranks]))
        assert float(merged["ystats"]["n"].sum()) > 0
        for r, got in enumerate(ranks):
            rec, where = got["int8_syncs"][s], f"rank {r} sync {s}: "
            mine = jax.tree.map(lambda a: a[r], merged)
            assert_bitwise(rec["merged"], jax.tree.map(np.asarray, mine),
                           where + "merged delta")
            ref, raux = apply(jax.tree.map(jnp.asarray, rec["forest_before"]),
                              mine)
            assert_forest_holds(ref, rec["forest"], where)
            assert_close_tree(rec["aux"], raux, where + "aux")


def test_int8_refuses_the_sketch_observer():
    _, tc = configs("sketch")
    with pytest.raises(ValueError, match="sketch"):
        tsh.build_data_parallel_forest(tc, compress="int8", device="cpu")


def test_quantized_all_reduce_matches_quantized_psum(gloo_run):
    world, arrays, ranks = gloo_run
    tree = {"a": jnp.asarray(arrays["a"]),
            "b": {"c": jnp.asarray(arrays["c"])}}
    ref = jax.vmap(lambda t: jcompress.quantized_psum(t, "d"),
                   axis_name="d")(tree)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["qar"]["a"], np.asarray(ref["a"][r]))
        np.testing.assert_array_equal(got["qar"]["b"]["c"],
                                      np.asarray(ref["b"]["c"][r]))
        np.testing.assert_array_equal(got["inputs_after"]["a"],
                                      arrays["a"][r])


def test_int8_encode_round_trip_matches_reference():
    g = np.random.default_rng(0).normal(0, 2, (6, 9)).astype(np.float32)
    q, s = tcompress.int8_encode(torch.tensor(g))
    jq, js_ = jcompress.int8_encode(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js_)
    np.testing.assert_array_equal(tcompress.int8_decode(q, s).numpy(),
                                  np.asarray(jcompress.int8_decode(jq, js_)))
