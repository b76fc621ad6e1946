"""The tree-axis sharded forest, request-sharded serving and
``sketch.all_merge`` over ``torch.distributed`` (the rest of the
reference's ``train/sharding.py``, DESIGN.md §5).

* Two gloo ranks (spawned processes; FileStore, 60 s collective timeout,
  bounded join, ranks killed on timeout) hold the sharded forest against
  the unsharded port forest over 12 batches of 256 rows (the reference
  test's shape, ``tests/test_forest.py``): ``n_nodes`` exact, each rank's
  members and the replicated generator state bitwise while no drift swap
  fires, predictions within 1e-4 and ``forest_mse`` within 1e-5 (the vote
  sums its two halves in another order).  The same ranks split a request
  with ``build_sharded_serving`` and merge their halves of a stream's QO
  table with ``all_merge`` (tolerances of ``tests/test_sharding.py``).
* In one process (a one-rank gloo group): request-sharded serving equals
  ``predict_snapshot`` bitwise, a shallower snapshot serves, a deeper one
  or a single tree is refused.

No JAX here: the sharded port is held against the unsharded port, which
``tests/test_torch_forest.py`` holds against the reference.
"""
import datetime
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import qo as tqo
from repro_torch.core import serve as tsv
from repro_torch.core import sketch as tsk
from repro_torch.data import synth
from repro_torch.train import sharding as tsh

CPU = "cpu"
WORLD, BATCHES, ROWS = 2, 12, 256
JOIN_SECONDS = 240
CFG = tfr.ForestConfig(
    tree=tht.HTRConfig(n_features=4, max_nodes=31, n_bins=32,
                       grace_period=200, max_depth=6, r0=0.25),
    n_trees=8)


def _init_group(tmp, rank, world):
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))


def _merge_stream(world):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, world * 2000).astype(np.float32)
    return x.reshape(world, -1)


def _rank_main(rank, world, tmp):
    import torch.distributed as dist
    torch.set_num_threads(1)
    _init_group(tmp, rank, world)
    try:
        X, y = synth.piecewise_regression(BATCHES * ROWS, 4, seed=7)
        sharded = tsh.build_sharded_forest(CFG, device=CPU)
        s_ref = tfr.init_forest(CFG, 3, device=CPU)
        s_shd = sharded.shard(s_ref)
        fmse, drift = [], 0
        for i in range(0, BATCHES * ROWS, ROWS):
            xb, yb = X[i:i + ROWS], y[i:i + ROWS]
            s_ref, aux_r = tfr.update(CFG, s_ref, xb, yb, device=CPU)
            s_shd, aux_s = sharded.update(s_shd, xb, yb)
            fmse.append((float(aux_r["forest_mse"]),
                         float(aux_s["forest_mse"])))
            drift += int(aux_r["drift"].sum()) + int(aux_s["drift"].sum())
        Xt = X[:512]
        snap = tsv.freeze(s_ref, device=CPU)
        serve = tsh.build_sharded_serving(snap, device=CPU)
        table = tqo.update(tqo.init(64, radius=0.2, device=CPU),
                           _merge_stream(world)[rank],
                           _merge_stream(world)[rank], device=CPU)
        merged = tsk.all_merge(table)
        torch.save({"ref": s_ref, "shd": s_shd, "fmse": fmse,
                    "drift": drift,
                    "p_ref": tfr.predict(CFG, s_ref, Xt, device=CPU),
                    "p_shd": sharded.predict(s_shd, Xt),
                    "served": serve(snap, Xt),
                    "snapshot": tsv.predict_snapshot(snap, Xt, device=CPU),
                    "merged": merged},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded"))
    ctx = mp.spawn(_rank_main, args=(WORLD, tmp), nprocs=WORLD, join=False)
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
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _rows(tree, rows):
    return {k: (_rows(v, rows) if isinstance(v, dict) else v[rows])
            for k, v in tree.items()}


def _assert_bitwise(a, b, where=""):
    if isinstance(a, dict):
        for k in a:
            _assert_bitwise(a[k], b[k], f"{where}/{k}")
    else:
        assert torch.equal(a, b), where


def test_sharded_forest_matches_unsharded(gloo_run):
    ref = gloo_run[0]["ref"]
    assert all(torch.equal(r["ref"]["trees"]["n_nodes"],
                           ref["trees"]["n_nodes"]) for r in gloo_run)
    assert int(ref["trees"]["n_nodes"].min()) > 1, "a tree never split"
    n_nodes = torch.cat([r["shd"]["trees"]["n_nodes"] for r in gloo_run])
    assert torch.equal(n_nodes, ref["trees"]["n_nodes"])
    for r in gloo_run:
        np.testing.assert_allclose(r["p_shd"].numpy(), r["p_ref"].numpy(),
                                   rtol=0, atol=1e-4)
        fm = np.asarray(r["fmse"])
        np.testing.assert_allclose(fm[:, 1], fm[:, 0], rtol=0, atol=1e-5)


def test_sharded_members_and_generator_are_bitwise(gloo_run):
    """No drift swap fired, so each rank's members are the unsharded
    forest's rows bit for bit, and the generator state stays replicated."""
    assert all(r["drift"] == 0 for r in gloo_run)
    T = CFG.n_trees
    for rank, r in enumerate(gloo_run):
        mine = slice(rank * T // WORLD, (rank + 1) * T // WORLD)
        shd = {k: v for k, v in r["shd"].items() if k != "rng"}
        _assert_bitwise(_rows({k: v for k, v in r["ref"].items()
                               if k != "rng"}, mine), shd, f"rank {rank}")
        assert torch.equal(r["shd"]["rng"], r["ref"]["rng"])


def test_request_sharded_serving_splits_the_rows(gloo_run):
    served = torch.cat([r["served"] for r in gloo_run])
    assert torch.equal(served, gloo_run[0]["snapshot"])


def test_all_merge_is_one_table_over_the_stream(gloo_run):
    x = _merge_stream(WORLD).reshape(-1)
    ref = tqo.update(tqo.init(64, radius=0.2, device=CPU), x, x, device=CPU)
    for r in gloo_run:
        out = r["merged"]
        np.testing.assert_allclose(out["y"]["n"].numpy(),
                                   ref["y"]["n"].numpy(), atol=1e-3)
        np.testing.assert_allclose(out["y"]["mean"].numpy(),
                                   ref["y"]["mean"].numpy(), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_allclose(out["y"]["m2"].numpy(),
                                   ref["y"]["m2"].numpy(), rtol=5e-3,
                                   atol=5e-3)
        np.testing.assert_allclose(out["sum_x"].numpy(),
                                   ref["sum_x"].numpy(), rtol=1e-5,
                                   atol=1e-3)


@pytest.fixture
def one_rank(tmp_path):
    import torch.distributed as dist
    _init_group(str(tmp_path), 0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_request_sharded_serving_on_one_rank(one_rank):
    X, y = synth.piecewise_regression(1024, 4, seed=9)
    fresh = tfr.init_forest(CFG, 1, device=CPU)
    shallow = tsv.freeze(fresh, device=CPU)
    state, _ = tfr.update_stream(CFG, tfr.init_forest(CFG, 1, device=CPU),
                                 X, y, device=CPU)
    deep = tsv.freeze(state, version=2, device=CPU)
    assert deep.depth > shallow.depth == 0
    serve = tsh.build_sharded_serving(deep, device=CPU)
    for snap in (deep, shallow):                     # shallower serves
        assert torch.equal(serve(snap, X[:300]),
                           tsv.predict_snapshot(snap, X[:300], device=CPU))
    with pytest.raises(ValueError, match="rebuild"):
        tsh.build_sharded_serving(shallow, device=CPU)(deep, X[:8])
    tree = {k: (v[0] if torch.is_tensor(v) else
                {kk: vv[0] for kk, vv in v.items()})
            for k, v in state["trees"].items()}
    with pytest.raises(ValueError, match="rebuild"):
        serve(tsv.freeze(tree, device=CPU), X[:8])


def test_sharded_forest_on_one_rank_is_the_forest(one_rank, monkeypatch):
    """One rank holds every member: the sharded forest is ``update``
    bitwise, ``forest_mse`` included; the vote is all-reduced once an
    update and once a predict."""
    import torch.distributed as dist
    reduces = []
    all_reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: (
        reduces.append(t.shape), all_reduce(t, *a, **k))[1])
    X, y = synth.piecewise_regression(4 * ROWS, 4, seed=10)
    sharded = tsh.build_sharded_forest(CFG, device=CPU)
    ref = tfr.init_forest(CFG, 4, device=CPU)
    shd = sharded.shard(ref)
    for i in range(0, 4 * ROWS, ROWS):
        ref, aux_r = tfr.update(CFG, ref, X[i:i + ROWS], y[i:i + ROWS],
                                device=CPU)
        shd, aux_s = sharded.update(shd, X[i:i + ROWS], y[i:i + ROWS])
        _assert_bitwise(ref, shd, f"batch {i // ROWS}")
        _assert_bitwise(aux_r, aux_s)
    assert torch.equal(sharded.predict(shd, X[:64]),
                       tfr.predict(CFG, ref, X[:64], device=CPU))
    assert reduces == [(ROWS + 1,)] * 4 + [(65,)]
    with pytest.raises(ValueError, match="do not split"):
        tsh.forest_state_specs(ref, 0, 3)
