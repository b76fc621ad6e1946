"""Port parity: checkpoints (the reference's ``checkpoint/ckpt.py``).

* Every case of ``tests/test_checkpoint.py`` against the port's
  ``Checkpointer`` on CPU tensors: round-trip, LATEST and gc, async save,
  corruption, truncation, fall-back past a corrupt newest step, nothing
  valid, schema mismatch, ``available_steps``, ``reshard``, a forest
  state and a snapshot round-tripping to bitwise-equal predictions, and a
  snapshot's ``version`` / ``step`` restored by value.
* Across packages (same on-disk format): reference tree states and
  snapshots restore into port templates and serve as the reference does,
  and the reference restores the port's; a reference forest checkpoint
  reaches the port through a numpy template and
  ``convert.state_from_numpy`` and learns the next batch alike; a port
  forest checkpoint is refused by the reference (no ``keys``) and a
  card-written one by a CPU template (ROADMAP C13).
* An async save followed at once by an in-place ``forest.update``
  restores the pre-update state bit for bit.
"""
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import forest as jfr
from repro.core import hoeffding as jht
from repro.core import serve as jsv
from repro_torch import convert
from repro_torch.checkpoint.ckpt import (CheckpointCorruption, Checkpointer,
                                         reshard)
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import serve as tsv
from repro_torch.data import synth
from tests.test_torch_forest import TREE_KW, assert_tree_holds, learn_both

CPU = "cpu"


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.as_tensor(
                           rng.normal(0, 1, (32, 16)).astype(np.float32)),
                       "b": torch.zeros(16)},
            "opt": {"m": torch.as_tensor(
                        rng.normal(0, 1, (32, 16)).astype(np.float32)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _template(tree):
    """A template of the same structure with other values."""
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    return torch.full_like(tree, 3)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_equal_trees(a[k], b[k])
    else:
        assert torch.is_tensor(b) and b.dtype == a.dtype \
            and b.device == a.device
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(0)
    ck.save(10, tree, blocking=True)
    assert ck.latest_step() == 10
    assert_equal_trees(tree, ck.restore(10, _template(tree)))


def test_on_disk_layout_is_the_reference_layout(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(10, _tree(0), blocking=True)
    d = tmp_path / "step_000000010"
    assert sorted(os.listdir(d)) == ["manifest.json", "shard_0.npz"]
    assert (tmp_path / "LATEST").read_text() == "step_000000010"
    assert not any(p.startswith(".") for p in os.listdir(tmp_path))
    names = set(np.load(d / "shard_0.npz"))
    assert names == {"params/w", "params/b", "opt/m", "opt/step"}
    # the reference's Checkpointer reads it
    rest = jckpt.Checkpointer(str(tmp_path)).restore(
        10, jax.tree.map(np.asarray, convert.state_to_numpy(_tree(0))))
    np.testing.assert_array_equal(rest["params"]["w"], _tree(0)["params"]["w"])


def test_latest_pointer_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree(1)
    for s in (5, 10, 15):
        ck.save(s, tree, blocking=True)
    assert ck.latest_step() == 15
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000010", "step_000000015"]  # gc kept last 2


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(2)
    ck.save(1, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1
    assert_equal_trees(tree, ck.restore(1, _template(tree)))


def _corrupt_shard(tmp_path, step):
    shard = tmp_path / f"step_{step:09d}" / "shard_0.npz"
    data = dict(np.load(shard))
    k = sorted(data)[0]
    data[k] = data[k] + 1.0
    np.savez(shard, **data)


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(3)
    ck.save(1, tree, blocking=True)
    _corrupt_shard(tmp_path, 1)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1, _template(tree))


def _small_forest():
    cfg = tfr.ForestConfig(
        tree=tht.HTRConfig(n_features=4, max_nodes=31, n_bins=32,
                           grace_period=50, max_depth=6, r0=0.25),
        n_trees=4)
    X, y = synth.piecewise_regression(768, n_features=4, seed=11)
    state = tfr.init_forest(cfg, 2, device=CPU)
    state, _ = tfr.update_stream(cfg, state, X, y, device=CPU)
    return cfg, state, X[:256]


def test_forest_state_roundtrip_predict_bitwise(tmp_path):
    cfg, state, X = _small_forest()
    assert int(state["trees"]["n_nodes"].max()) > 1          # trained
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, blocking=True)
    rest = ck.restore_latest(tfr.init_forest(cfg, 9, device=CPU))
    assert_equal_trees(state, rest)
    assert torch.equal(tfr.predict(cfg, state, X, device=CPU),
                       tfr.predict(cfg, rest, X, device=CPU))


def test_snapshot_roundtrip_predict_bitwise(tmp_path):
    cfg, state, X = _small_forest()
    snap = tsv.freeze(state, device=CPU)
    ck = Checkpointer(str(tmp_path))
    ck.save(7, snap, blocking=True)
    assert set(np.load(tmp_path / "step_000000007" / "shard_0.npz")) == \
        {str(i) for i in range(8)}
    rest = ck.restore_latest(snap)
    assert (rest.depth, rest.single) == (snap.depth, snap.single)
    for a, b in zip(snap.leaves()[:6], rest.leaves()[:6]):
        assert torch.equal(a, b)
    assert torch.equal(tsv.predict_snapshot(snap, X, device=CPU),
                       tsv.predict_snapshot(rest, X, device=CPU))


def test_version_and_step_round_trip_through_checkpoint(tmp_path):
    cfg, state, X = _small_forest()
    snap = tsv.freeze(state, version=17, step=123, device=CPU)
    ck = Checkpointer(str(tmp_path))
    ck.save(123, snap, blocking=True)
    # the template carries DIFFERENT stamps: restore brings back the
    # saved identity (leaves, not aux)
    template = tsv.freeze(state, version=1, step=0, device=CPU)
    rest = ck.restore_latest(template)
    assert (rest.version, rest.step) == (17, 123)
    assert isinstance(rest.version, int) and isinstance(rest.step, int)
    assert torch.equal(tsv.predict_snapshot(rest, X[:100], device=CPU),
                       tsv.predict_snapshot(snap, X[:100], device=CPU))


def test_restore_latest_empty_dir(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore_latest({"w": torch.zeros(2)})


def test_reshard_onto_the_cpu(tmp_path):
    """Elastic restart: a tree restored as numpy, placed onto devices."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(32.0).reshape(8, 4),
            "b": {"c": torch.arange(3, dtype=torch.int32)}}
    ck.save(1, tree, blocking=True)
    rest = ck.restore(1, convert.state_to_numpy(tree))
    assert isinstance(rest["w"], np.ndarray)
    placed = reshard(rest, {"w": torch.device(CPU), "b": {"c": CPU}})
    assert_equal_trees(tree, placed)


def test_available_steps_lists_completed_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=10)
    tree = _tree(4)
    for s in (3, 1, 2):
        ck.save(s, tree, blocking=True)
    assert ck.available_steps() == [1, 2, 3]
    os.makedirs(tmp_path / ".tmp_step_000000009")
    assert ck.available_steps() == [1, 2, 3]


def test_restore_latest_falls_back_past_corrupt_newest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=10)
    good = _tree(5)
    ck.save(1, good, blocking=True)
    ck.save(2, {k: {kk: (vv * 0 + 9 if vv.is_floating_point() else vv)
                    for kk, vv in v.items()} for k, v in good.items()},
            blocking=True)
    _corrupt_shard(tmp_path, 2)
    rest, step = ck.restore_latest(_template(good), return_step=True)
    assert step == 1
    assert_equal_trees(good, rest)


def test_restore_latest_falls_back_past_truncated_npz(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=10)
    good = _tree(6)
    ck.save(4, good, blocking=True)
    ck.save(7, good, blocking=True)
    shard = tmp_path / "step_000000007" / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:40])  # cut mid-write
    rest, step = ck.restore_latest(_template(good), return_step=True)
    assert step == 4


def test_restore_latest_raises_when_nothing_valid(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(7)
    ck.save(1, tree, blocking=True)
    _corrupt_shard(tmp_path, 1)
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        ck.restore_latest(_template(tree))


def test_restore_detects_schema_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree(8)
    ck.save(1, tree, blocking=True)
    shard = tmp_path / "step_000000001" / "shard_0.npz"
    data = dict(np.load(shard))
    k = sorted(data)[0]
    data[k] = data[k].reshape(-1)  # same bytes, wrong shape
    np.savez(shard, **data)
    with pytest.raises(CheckpointCorruption, match="corruption in leaf"):
        ck.restore(1, _template(tree))


# --------------------------------------------------------------------------
# across packages: one on-disk format
# --------------------------------------------------------------------------

def _configs():
    return jht.HTRConfig(split_backend="jnp", **TREE_KW), \
        tht.HTRConfig(**TREE_KW)


def _reference_tree(jc, n=2000):
    upd = jax.jit(functools.partial(jht.update, jc))
    X, y = synth.piecewise_regression(n, 4, seed=51)
    js = jht.init_state(jc)
    for i in range(0, n, 250):
        js = upd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
    assert int(js["n_nodes"]) > 1
    return js


def _reference_forest(n_batches=4):
    jc = jfr.ForestConfig(tree=jht.HTRConfig(split_backend="jnp", **TREE_KW),
                          n_trees=4)
    tc = tfr.ForestConfig(tree=tht.HTRConfig(**TREE_KW), n_trees=4)
    upd = jax.jit(functools.partial(jfr.update, jc))
    X, y = synth.piecewise_regression(250 * (n_batches + 1), 4, seed=52)
    js = jfr.init_forest(jc, jax.random.PRNGKey(3))
    for i in range(0, 250 * n_batches, 250):
        js, _ = upd(js, jnp.asarray(X[i:i + 250]), jnp.asarray(y[i:i + 250]))
    return jc, tc, js, upd, X, y


def _test_rows():
    Xt, _ = synth.piecewise_regression(300, 4, seed=53)
    Xt[0] = np.nan
    return Xt


def test_reference_tree_and_snapshots_restore_in_the_port(tmp_path):
    jc, tc = _configs()
    js = _reference_tree(jc)
    jsnap = jsv.freeze(js, version=5, step=8)
    jfc, tfc, jforest, *_ = _reference_forest()
    jfsnap = jsv.freeze(jforest, version=6, step=4)
    for i, tree in enumerate((js, jsnap, jfsnap)):
        jckpt.Checkpointer(str(tmp_path / str(i))).save(1, tree,
                                                        blocking=True)
    Xt = _test_rows()

    ts = Checkpointer(str(tmp_path / "0")).restore(
        1, tht.init_state(tc, device=CPU))
    assert all(torch.is_tensor(v) for v in jax.tree.leaves(ts))
    assert_tree_holds(js, convert.state_to_numpy(ts))
    np.testing.assert_array_equal(
        tht.predict(tc, ts, Xt, device=CPU).numpy(),
        np.asarray(jht.predict(jc, js, jnp.asarray(Xt))))
    # a snapshot: the port's freeze of the restored state is the template
    tsnap = Checkpointer(str(tmp_path / "1")).restore(
        1, tsv.freeze(ts, device=CPU))
    assert (tsnap.version, tsnap.step) == (5, 8)
    for k, v in convert.snapshot_to_numpy(tsnap).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jsnap, k)))
    np.testing.assert_array_equal(
        tsv.predict_snapshot(tsnap, Xt, device=CPU).numpy(),
        np.asarray(jsv.predict_snapshot(jsnap, jnp.asarray(Xt))))
    # a forest snapshot: topology exact, the vote within 1e-6
    T, Mr = np.shape(jfsnap.feature)
    template = tsv.Snapshot(
        feature=torch.zeros((T, Mr), dtype=torch.int32),
        threshold=torch.zeros((T, Mr)),
        child=torch.full((T, Mr, 2), -1, dtype=torch.int32),
        is_leaf=torch.ones((T, Mr), dtype=torch.bool),
        leaf_mean=torch.zeros((T, Mr)), vote_w=torch.zeros(T),
        depth=jfsnap.depth, single=False)
    tfsnap = Checkpointer(str(tmp_path / "2")).restore(1, template)
    assert (tfsnap.version, tfsnap.step) == (6, 4)
    for k, v in convert.snapshot_to_numpy(tfsnap).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jfsnap, k)))
    np.testing.assert_allclose(
        tsv.predict_snapshot(tfsnap, Xt, device=CPU).numpy(),
        np.asarray(jsv.predict_snapshot(jfsnap, jnp.asarray(Xt))),
        rtol=1e-6, atol=1e-6)


def test_port_tree_and_snapshot_restore_in_the_reference(tmp_path):
    jc, tc = _configs()
    X, y = synth.piecewise_regression(2000, 4, seed=54)
    ts = tht.update_stream(tc, tht.init_state(tc, device=CPU), X, y,
                           batch_size=250, device=CPU)
    assert int(ts["n_nodes"]) > 1
    tsnap = tsv.freeze(ts, version=3, step=9, device=CPU)
    Checkpointer(str(tmp_path / "t")).save(2, ts, blocking=True)
    Checkpointer(str(tmp_path / "s")).save(2, tsnap, blocking=True)
    js = jckpt.Checkpointer(str(tmp_path / "t")).restore(
        2, jax.eval_shape(lambda: jht.init_state(jc)))
    assert_tree_holds(js, convert.state_to_numpy(ts))
    Xt = _test_rows()
    np.testing.assert_array_equal(
        np.asarray(jht.predict(jc, js, jnp.asarray(Xt))),
        tht.predict(tc, ts, Xt, device=CPU).numpy())
    jsnap = jckpt.Checkpointer(str(tmp_path / "s")).restore(
        2, jsv.freeze(js))
    assert int(jsnap.version) == 3 and int(jsnap.step) == 9
    assert (jsnap.depth, jsnap.single) == (tsnap.depth, tsnap.single)
    np.testing.assert_array_equal(
        np.asarray(jsv.predict_snapshot(jsnap, jnp.asarray(Xt))),
        tsv.predict_snapshot(tsnap, Xt, device=CPU).numpy())


def test_reference_forest_reaches_the_port_through_convert(tmp_path):
    """A reference forest checkpoint restores into a numpy template of the
    reference's layout (built from a port state plus ``keys``), crosses
    through ``convert.state_from_numpy`` and learns the next batch as the
    reference does (injected draws, 1e-4)."""
    jc, tc, js, upd, X, y = _reference_forest()
    jckpt.Checkpointer(str(tmp_path)).save(4, js, blocking=True)
    template = dict(convert.state_to_numpy(tfr.init_forest(tc, device=CPU)),
                    keys=np.zeros((tc.n_trees, 2), np.uint32))
    rest, step = Checkpointer(str(tmp_path)).restore_latest(
        template, return_step=True)
    assert step == 4 and isinstance(rest["vote_w"], np.ndarray)
    ts = convert.state_from_numpy(rest, CPU)
    learn_both(jc, tc, js, ts, X[1000:], y[1000:], upd)


def test_port_forest_checkpoints_do_not_cross(tmp_path):
    """ROADMAP C13: the reference refuses a port forest checkpoint (it has
    ``rng``, not ``keys``), and a forest written on the card (a 16-byte
    CUDA generator state) does not restore into a CPU template."""
    jc, tc, js, *_ = _reference_forest(n_batches=1)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), CPU)
    Checkpointer(str(tmp_path / "cpu")).save(1, ts, blocking=True)
    with pytest.raises(jckpt.CheckpointCorruption, match="keys"):
        jckpt.Checkpointer(str(tmp_path / "cpu")).restore(
            1, jax.eval_shape(lambda: js))
    card = dict(ts, rng=torch.zeros(16, dtype=torch.uint8))
    Checkpointer(str(tmp_path / "card")).save(1, card, blocking=True)
    with pytest.raises(CheckpointCorruption, match="rng"):
        Checkpointer(str(tmp_path / "card")).restore(1, ts)
    # the generator state itself round-trips onto the CPU
    rest = Checkpointer(str(tmp_path / "cpu")).restore(1, ts)
    assert rest["rng"].device.type == "cpu" and torch.equal(rest["rng"],
                                                            ts["rng"])


def test_async_save_then_in_place_update_restores_pre_update(tmp_path,
                                                             monkeypatch):
    """``save`` copies every leaf before it returns: the writer thread is
    held back until an in-place ``forest.update`` has rewritten the QO
    tables, and the checkpoint still holds the pre-update state."""
    cfg, state, X = _small_forest()
    before = _clone(state)
    release = threading.Event()
    savez = np.savez

    def held_savez(*a, **k):
        assert release.wait(timeout=60)
        return savez(*a, **k)

    monkeypatch.setattr(np, "savez", held_savez)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    tables = state["trees"]["ao_y"]["n"]
    Xb, yb = synth.piecewise_regression(256, 4, seed=55)
    state, _ = tfr.update(cfg, state, Xb, yb, device=CPU)
    assert state["trees"]["ao_y"]["n"] is tables        # written in place
    assert not torch.equal(tables, before["trees"]["ao_y"]["n"])
    release.set()
    ck.wait()
    rest = ck.restore(1, state)
    assert_equal_trees(before, rest)
