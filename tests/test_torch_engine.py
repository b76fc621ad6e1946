"""Port parity: the continuous-serving engine and fault injection (the
reference's ``core/engine.py`` and ``core/faults.py``, DESIGN.md §5.6).

* Every scenario of ``tests/test_engine.py`` against the port's engine on
  the CPU (``device="cpu"``), stepped through ``train_once`` /
  ``serve_once`` so the fault timing is exact, plus the one threaded test
  (every wait and join bounded).  The invariant under every injected
  fault: every admitted request is served from a validated published
  snapshot, bit for bit ``predict_snapshot`` of that version, sheds are
  counted, and the engine recovers to publishing.  (The reference's
  ``version``/``step`` checkpoint round trip is in
  ``tests/test_torch_checkpoint.py``.)
* A single-tree engine beside the reference's, through the same stream
  and fault schedule: equal counters, versions, steps and snapshot
  topology, leaf means and served rows within 1e-4.
* A forest engine is the port's own ``forest.update`` loop, bitwise; a
  crash inside the step leaves the pre-step state; ``bursty_arrivals`` is
  the reference's schedule.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import engine as jeng
from repro.core import faults as jfl
from repro.core import hoeffding as jht
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.core import engine as eng
from repro_torch.core import faults as fl
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import serve as tsv
from repro_torch.train import sharding as tsh

CPU = "cpu"
TOL = 1e-4
F, B, N = 4, 64, 4096
TREE_KW = dict(n_features=F, max_nodes=31, n_bins=16, grace_period=40,
               max_depth=6, r0=0.3)
TCFG = tht.HTRConfig(**TREE_KW)
FCFG = tfr.ForestConfig(tree=TCFG, n_trees=4)


def _data():
    rng = np.random.default_rng(7)
    X = rng.normal(0, 1, (N, F)).astype(np.float32)
    y = (2.0 * (X[:, 0] > 0) + 0.1 * rng.normal(0, 1, N)).astype(np.float32)
    return X, y


X_ALL, Y_ALL = _data()


def stream(step):
    """Deterministic, step-indexed (wraps) -- crash recovery replays it."""
    i = (step * B) % (N - B)
    return X_ALL[i:i + B], Y_ALL[i:i + B]


def make_engine(tmp_path=None, injector=None, **cfg_kw):
    cfg = eng.EngineConfig(**{"sync_every": 2, "max_queue_rows": 512,
                              "max_batch_rows": 256, **cfg_kw})
    ck = Checkpointer(str(tmp_path)) if tmp_path is not None else None
    state = tfr.init_forest(FCFG, 0, device=CPU)
    return eng.ServingEngine(FCFG, state, stream, cfg=cfg, checkpointer=ck,
                             injector=injector, device=CPU)


def _served_bit_identical(e, t):
    """A ticket's rows == a standalone predict_snapshot on the version that
    served them, bitwise."""
    assert t.status == "done" and t.version is not None
    snap = e.snapshot_for_version(t.version)
    ref = tsv.predict_snapshot(snap, t.X, device=CPU).numpy()
    np.testing.assert_array_equal(t.result, ref)


def _with(t, index, value):
    """A copy of tensor ``t`` with ``t[index] = value``."""
    t = t.clone()
    t[index] = value
    return t


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def assert_bitwise(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_bitwise(a[k], b[k], f"{where}/{k}")
    else:
        assert torch.equal(a, b), where


# -- publish / versioning --------------------------------------------------

def test_engine_publishes_on_cadence_with_monotone_versions():
    e = make_engine()
    assert e.published_version == 1          # never cold-starts
    seen = [e.published_version]
    for _ in range(6):
        e.train_once()
        if e.published_version != seen[-1]:
            seen.append(e.published_version)
    assert seen == [1, 2, 3, 4]              # sync_every=2 over 6 steps
    st = e.staleness()
    assert st["published_step"] == 6 and st["age_steps"] == 0
    assert not st["stale"]


def test_stale_publish_version_is_rejected():
    e = make_engine()
    e.train_once(), e.train_once()           # published v2
    old = tsv.freeze(tfr.init_forest(FCFG, 1, device=CPU), version=1,
                     step=0, device=CPU)     # not past v2
    assert not e.publish(old)
    assert e.published_version == 2
    assert e.metrics()["rollbacks"] == 1


# -- fault: trainer killed mid-sync-window ---------------------------------

def test_trainer_kill_mid_window_serving_uninterrupted(tmp_path):
    inj = fl.FaultInjector()
    e = make_engine(tmp_path, inj)
    for _ in range(4):
        e.train_once()                       # v3 published, ckpt at step 4
    v_before = e.published_version

    inj.arm("trainer.step", fl.Kill(), after=1)
    tickets = []
    for k in range(3):                       # steps 5 (ok), 6 (kill), 7
        tickets.append(e.submit(X_ALL[k * 10:k * 10 + 10]))
        e.train_once()
        while e.serve_once():
            pass
    assert inj.fired("trainer.step") == 1

    m = e.metrics()
    assert m["trainer_crashes"] == 1 and m["recoveries"] == 1
    assert all(t.status == "done" for t in tickets)
    for t in tickets:
        _served_bit_identical(e, t)
    assert e.published_version > v_before
    v_recov = e.published_version
    for _ in range(e.cfg.sync_every):
        e.train_once()
    assert e.published_version > v_recov
    assert e.metrics()["trainer_crashes"] == 1      # no repeat crash


def test_recovery_restores_from_checkpoint_step(tmp_path):
    inj = fl.FaultInjector()
    e = make_engine(tmp_path, inj)
    for _ in range(4):
        e.train_once()                       # last ckpt at step 4
    at_ckpt = _clone(e._state)
    e.train_once()                           # step 5 (mid-window)
    assert e._trainer_step == 5
    inj.arm("trainer.step", fl.Kill())
    e.train_once()                           # dies -> restore
    assert e._trainer_step == 4              # rewound to the ckpt step
    assert e._published.snap.step == 4
    assert_bitwise(at_ckpt, e._state)        # rng and every table


def test_recovery_without_checkpointer_falls_back_to_memory():
    inj = fl.FaultInjector()
    e = make_engine(None, inj)
    for _ in range(3):
        e.train_once()
    step = e._trainer_step
    inj.arm("trainer.step", fl.Kill())
    e.train_once()
    m = e.metrics()
    assert m["trainer_crashes"] == 1 and m["recoveries"] == 1
    assert e._trainer_step == step           # in-memory state kept
    assert e.published_version >= 2          # still re-published


# -- fault: corrupt publish -> rollback ------------------------------------

def test_corrupt_publish_rolls_back_to_last_good():
    inj = fl.FaultInjector()
    e = make_engine(None, inj)
    e.train_once(), e.train_once()           # v2 out
    v_good = e.published_version
    good_snap = e.snapshot_for_version(v_good)

    inj.arm("publish", fl.Corrupt(lambda s: dataclasses.replace(
        s, vote_w=_with(s.vote_w, 0, float("nan")))))
    e.train_once(), e.train_once()           # boundary: corrupt publish
    assert inj.fired("publish") == 1
    m = e.metrics()
    assert m["publish_failures"] == 1 and m["rollbacks"] == 1
    assert e.published_version == v_good
    t = e.submit(X_ALL[:50])
    e.serve_once()
    assert t.version == v_good
    np.testing.assert_array_equal(
        t.result, tsv.predict_snapshot(good_snap, t.X, device=CPU).numpy())
    e.train_once(), e.train_once()
    assert e.published_version > v_good


def test_corrupt_vote_weights_and_child_range_rejected():
    e = make_engine()
    e.train_once(), e.train_once()
    snap = e.snapshot_for_version(e.published_version)
    bad_vote = dataclasses.replace(snap, vote_w=_with(snap.vote_w, 0, -1.0),
                                   version=99, step=99)
    assert not e.publish(bad_vote)
    bad_child = dataclasses.replace(
        snap, child=torch.full_like(snap.child, snap.feature.shape[1]),
        version=99, step=99)
    assert not e.publish(bad_child)
    assert e.metrics()["rollbacks"] == 2


# -- fault: dropped publishes -> staleness watchdog ------------------------

def test_dropped_publishes_trip_staleness_watchdog():
    inj = fl.FaultInjector()
    e = make_engine(None, inj, sync_every=2, staleness_factor=2.0)
    e.train_once(), e.train_once()           # v2 at step 2
    inj.arm("publish", fl.Drop(), times=4)   # lose the next 4 publishes
    for _ in range(8):
        e.train_once()
    m = e.metrics()
    assert m["publishes_dropped"] == 4
    st = e.staleness()
    assert st["published_step"] == 2 and st["age_steps"] == 8
    assert st["stale"] and m["stale_events"] > 0
    e.train_once(), e.train_once()
    assert not e.staleness()["stale"]
    assert e.published_version == 3          # monotone, no version holes


# -- admission control ------------------------------------------------------

def test_queue_overflow_sheds_exactly_the_excess():
    e = make_engine(None, None, max_queue_rows=512)
    tickets = [e.submit(X_ALL[:200]) for _ in range(4)]
    assert [t.status for t in tickets] == ["queued", "queued", "shed", "shed"]
    m = e.metrics()
    assert m["admitted_rows"] == 400 and m["shed_rows"] == 400
    assert m["shed_requests"] == 2
    assert tickets[2].wait(timeout=1) and tickets[2].result is None
    while e.serve_once():
        pass
    assert e.submit(X_ALL[:200]).status == "queued"
    assert e.metrics()["served_rows"] == 400


def test_packed_batch_splits_per_ticket_bit_identically():
    e = make_engine(None, None, max_batch_rows=256)
    sizes = (100, 37, 119)                    # packs into one 256-row batch
    tickets = [e.submit(X_ALL[i * 200:i * 200 + s])
               for i, s in enumerate(sizes)]
    assert e.serve_once() == sum(sizes)
    assert e.metrics()["serve_batches"] == 1  # ONE dispatch for all three
    for t in tickets:
        _served_bit_identical(e, t)


def test_inflight_requests_drain_on_the_pinned_version():
    e = make_engine()
    t_old = e.submit(X_ALL[:80])
    e.train_once(), e.train_once()           # hot-swap to v2 while queued
    e.serve_once()
    assert t_old.version == e.published_version    # served post-swap: v2
    _served_bit_identical(e, t_old)


# -- threaded deployment shape ---------------------------------------------

def test_threaded_engine_serves_everything_admitted(tmp_path):
    inj = fl.FaultInjector()
    inj.arm("trainer.step", fl.Kill(), after=3)
    e = make_engine(tmp_path, inj, sync_every=2, max_queue_rows=4096,
                    max_batch_rows=512)
    e.start()
    try:
        tickets = [e.submit(X_ALL[i % 32:(i % 32) + 48]) for i in range(20)]
        deadline = time.monotonic() + 120
        while (e.metrics()["recoveries"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        tickets += [e.submit(X_ALL[i % 32:(i % 32) + 48]) for i in range(20)]
        admitted = [t for t in tickets if t.status != "shed"]
        for t in admitted:
            assert t.wait(timeout=30), "admitted ticket never served"
    finally:
        threads = list(e._threads)
        e.stop(drain=True, timeout=30)
    assert not any(t.is_alive() for t in threads)
    m = e.metrics()
    assert m["trainer_crashes"] == 1 and m["recoveries"] == 1
    assert all(t.status == "done" for t in admitted)
    assert m["served_requests"] == len(admitted)
    assert m["served_rows"] + m["shed_rows"] == sum(t.rows for t in tickets)
    for t in admitted:                       # zero torn reads, bitwise
        _served_bit_identical(e, t)


# -- publish boundary on the data-parallel trainer -------------------------

def test_dp_on_sync_is_a_publish_boundary():
    calls = []

    def on_sync(forest, step, aux):
        calls.append((step, tsv.freeze(forest, version=len(calls) + 1,
                                       step=step, device=CPU)))

    init, update, _, predict = tsh.build_data_parallel_reference(
        FCFG, 2, sync_every=2, on_sync=on_sync, device=CPU)
    st = init(0)
    for k in range(4):
        st, aux = update(st, X_ALL[k * B:(k + 1) * B],
                         Y_ALL[k * B:(k + 1) * B])
        assert (aux is None) == bool((k + 1) % 2)
    assert [s for s, _ in calls] == [2, 4]   # fired exactly at boundaries
    step, snap = calls[-1]
    assert torch.equal(tsv.predict_snapshot(snap, X_ALL[:B], device=CPU),
                       predict(st, X_ALL[:B]))
    assert snap.version == 2


# -- the port's own pins ----------------------------------------------------

def test_forest_engine_is_the_update_loop():
    """Without faults the engine's state is the ``forest.update`` loop's,
    bit for bit (generator state and every QO table included), and its
    last publish is ``freeze`` of that state."""
    e = make_engine()
    loop = tfr.init_forest(FCFG, 0, device=CPU)
    for step in range(6):
        assert e.train_once()
        loop, _ = tfr.update(FCFG, loop, *stream(step), device=CPU)
        assert_bitwise(loop, e._state, f"step {step + 1}")
    snap = e.snapshot_for_version(e.published_version)
    assert snap.step == 6
    want = tsv.freeze(loop, device=CPU)
    for a, b in zip(want.leaves()[:6], snap.leaves()[:6]):
        assert torch.equal(a, b)


def test_crash_inside_the_step_keeps_the_pre_step_state(monkeypatch):
    """A step that raises after the absorb wrote the QO tables in place
    leaves the engine with the state before the step (no checkpointer:
    the reference keeps its immutable pre-step state), and the replayed
    stream then matches an engine that never crashed, bitwise."""
    e, clean = make_engine(), make_engine()
    for _ in range(3):
        e.train_once(), clean.train_once()
    before = _clone(e._state)
    tables = e._state["trees"]["ao_y"]["n"]
    learn = tfr._learn

    def learn_then_die(*a, **k):
        learn(*a, **k)
        raise RuntimeError("trainer died after the absorb")

    monkeypatch.setattr(tfr, "_learn", learn_then_die)
    e.train_once()
    monkeypatch.setattr(tfr, "_learn", learn)
    m = e.metrics()
    assert m["trainer_crashes"] == 1 and m["recoveries"] == 1
    assert e._trainer_step == 3
    assert not torch.equal(tables, before["trees"]["ao_y"]["n"])  # torn
    assert_bitwise(before, e._state, "after the crash")
    for _ in range(3):
        e.train_once(), clean.train_once()
    assert_bitwise(clean._state, e._state, "replayed")


def test_bursty_arrivals_is_the_reference_schedule():
    kw = dict(base_rows=256, burst_factor=8, burst_every=10, burst_len=2,
              base_gap_s=0.02, seed=3)
    assert fl.bursty_arrivals(96, **kw) == jfl.bursty_arrivals(96, **kw)
    assert fl.bursty_arrivals(40) == jfl.bursty_arrivals(40)


def test_fault_injector_is_the_reference_contract():
    for mod in (fl, jfl):
        inj = mod.FaultInjector()
        inj.arm("s", mod.Drop(), times=2, after=1)
        assert inj.fire("s", 5) == 5
        for _ in range(2):
            with pytest.raises(mod.DropSignal):
                inj.fire("s", 5)
        assert inj.fire("s", 6) == 6 and not inj.armed("s")
        assert inj.fired("s") == 2
        with pytest.raises(mod.TrainerKilled, match="@ k"):
            inj.arm("k", mod.Kill()).fire("k")
        assert inj.arm("c", mod.Corrupt(lambda p: p + 1)).fire("c", 1) == 2


# -- beside the reference's engine -----------------------------------------

def _scenario(e, faults, mod, submit):
    """Drive one engine through the shared schedule; returns the per-step
    records and the tickets."""
    inj = e._injector
    records, tickets = [], []
    for k in range(18):
        if k == 5:
            inj.arm("trainer.step", mod.Kill(), after=1)
        if k == 9:
            inj.arm("publish", mod.Corrupt(faults["corrupt"]))
        if k == 12:
            inj.arm("publish", mod.Drop(), times=2)
        if k % 3 == 0:
            tickets.append(e.submit(submit(X_ALL[k * 7:k * 7 + 40 + k])))
        if k == 7:
            tickets.append(e.submit(submit(X_ALL[:600])))     # shed
        e.train_once()
        while e.serve_once():
            pass
        m = e.metrics()
        m.pop("age_s")
        snap = e.snapshot_for_version(e.published_version)
        records.append((m, e._trainer_step, snap))
    return records, tickets


def test_single_tree_engine_matches_the_reference_engine(tmp_path,
                                                        monkeypatch):
    # the reference engine calls hoeffding.update eagerly: jit it (the
    # same function) so the schedule takes seconds, not a minute
    monkeypatch.setattr(jht, "update", jax.jit(jht.update,
                                               static_argnums=(0,)))
    jc = jht.HTRConfig(split_backend="jnp", **TREE_KW)
    cfg = dict(sync_every=2, max_queue_rows=512, max_batch_rows=256)
    ref = jeng.ServingEngine(
        jc, jht.init_state(jc),
        lambda s: tuple(jnp.asarray(a) for a in stream(s)),
        cfg=jeng.EngineConfig(**cfg),
        checkpointer=jckpt.Checkpointer(str(tmp_path / "ref")),
        injector=jfl.FaultInjector())
    port = eng.ServingEngine(
        TCFG, tht.init_state(TCFG, device=CPU), stream,
        cfg=eng.EngineConfig(**cfg),
        checkpointer=Checkpointer(str(tmp_path / "port")),
        injector=fl.FaultInjector(), device=CPU)
    rr, rt = _scenario(ref, {"corrupt": lambda s: dataclasses.replace(
        s, leaf_mean=s.leaf_mean.at[0, 0].set(jnp.nan))}, jfl, np.asarray)
    pr, pt = _scenario(port, {"corrupt": lambda s: dataclasses.replace(
        s, leaf_mean=_with(s.leaf_mean, (0, 0), float("nan")))}, fl,
        np.asarray)
    for k, ((rm, rstep, rsnap), (pm, pstep, psnap)) in enumerate(zip(rr, pr)):
        assert pm == rm, f"step {k}"
        assert pstep == rstep, f"step {k}"
        assert (psnap.version, psnap.step, psnap.depth, psnap.single) == (
            int(rsnap.version), int(rsnap.step), rsnap.depth, rsnap.single)
        for name in ("feature", "child", "is_leaf"):
            np.testing.assert_array_equal(
                getattr(psnap, name).numpy(),
                np.asarray(getattr(rsnap, name)), err_msg=f"step {k} {name}")
        for name in ("threshold", "leaf_mean"):
            np.testing.assert_allclose(
                getattr(psnap, name).numpy(),
                np.asarray(getattr(rsnap, name)), rtol=TOL, atol=TOL,
                err_msg=f"step {k} {name}")
    m = pr[-1][0]
    assert m["trainer_crashes"] == 1 and m["recoveries"] == 1
    assert m["rollbacks"] == 1 and m["publishes_dropped"] == 2
    assert m["shed_requests"] == 1
    assert int(pr[-1][2].feature.shape[1]) > 8       # the tree grew
    assert [t.status for t in pt] == [t.status for t in rt]
    for p, r in zip(pt, rt):
        assert p.version == r.version
        if p.status == "done":
            np.testing.assert_allclose(p.result, np.asarray(r.result),
                                       rtol=TOL, atol=TOL)
