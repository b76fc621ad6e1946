"""The port's stage spans and counters (``repro_torch.perf.spans``).

A small forest learns a stream whose concept moves half-way, so that the
drift test swaps members and the regrowing trees attempt splits on some
steps and not on others (the capacity gate shuts a full tree's
attempts).  Under ``torch.profiler`` (host activity only) every stage of
``forest.update`` and of ``predict_snapshot`` is a span nested in its
step, and the counters match what the states show; with no profiler
nothing is recorded or counted, and the states are the same bit for bit.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile as tprofile

from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import serve as tsv
from repro_torch.data import synth
from repro_torch.perf import profile, spans

B, N = 250, 4000
LEARN_STAGES = ("forest.predict", "forest.bag", "forest.route", "forest.stats",
                "forest.absorb", "forest.attempt", "forest.drift",
                "forest.vote")
ATTEMPT_STAGES = ("forest.query", "forest.decide", "forest.apply")
SERVE_STAGES = ("serve.h2d", "serve.route", "serve.vote")
OBSERVERS = ("qo", "sketch")


def config(observer):
    tree = tht.HTRConfig(n_features=4, max_nodes=15, n_bins=32,
                         grace_period=100, max_depth=6, r0=0.25,
                         observer_backend=observer)
    return tfr.ForestConfig(tree=tree, n_trees=3, drift_min_batches=2,
                            drift_decay=0.6)


def stream():
    X, y = synth.piecewise_regression(N, 4, seed=13)
    y[N // 2:] = (synth.piecewise_target(X[N // 2:], shift=1.0) + 20.0
                  ).astype(np.float32)
    return X, y


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()


def learn(cfg, X, y):
    """A copy of every step's (state, aux), from a fresh forest (a step
    updates the QO tables in place)."""
    state = tfr.init_forest(cfg, 0, device="cpu")
    out = []
    for i in range(0, N, B):
        state, aux = tfr.update(cfg, state, X[i:i + B], y[i:i + B],
                                device="cpu")
        out.append((clone(state), aux))
    return out


def profiled(fn):
    """(fn's result, {span name: [(start, end)]}, counters), the counters
    reset before the profiler starts."""
    spans.reset_counts()
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        res = fn()
    found = {}
    for e in prof.events():
        if e.name.startswith(("forest.", "serve.")):
            found.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return res, found, spans.counts()


def inside(iv, outer):
    return [o for o in outer if o[0] <= iv[0] and iv[1] <= o[1]]


@pytest.fixture(scope="module", params=OBSERVERS)
def traced_run(request):
    cfg = config(request.param)
    X, y = stream()
    seen = {"attempt_steps": 0, "attempted": 0, "splits": 0}
    orig = tht.attempt_trees

    def attempt_trees(tcfg, trees, feat_mask=None):
        # the attempt mask and the capacity gate, computed apart
        M = trees["is_leaf"].shape[1]
        gate = tht.attempt_mask(tcfg, trees) & (trees["n_nodes"][:, None] + 1 < M)
        seen["attempt_steps"] += bool(gate.any())
        seen["attempted"] += int(gate.sum())
        n0 = trees["n_nodes"].clone()
        out = orig(tcfg, trees, feat_mask)
        seen["splits"] += int((out["n_nodes"] - n0).sum()) // 2
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tht, "attempt_trees", attempt_trees)
    try:
        steps, found, counts = profiled(lambda: learn(cfg, X, y))
    finally:
        mp.undo()
    return cfg, X, y, steps, found, counts, seen


def test_every_stage_span_nests_in_its_step(traced_run):
    _, _, _, steps, found, _, _ = traced_run
    updates = found["forest.update"]
    assert len(updates) == len(steps)
    for name in LEARN_STAGES:
        assert len(found[name]) >= len(steps), name
        for iv in found[name]:
            assert len(inside(iv, updates)) == 1, name
    for name in ATTEMPT_STAGES:
        for iv in found[name]:
            assert len(inside(iv, found["forest.attempt"])) == 1, name
    for iv in found["forest.swap"]:
        assert len(inside(iv, updates)) == 1


def test_split_stages_run_on_exactly_the_attempting_steps(traced_run):
    _, _, _, steps, found, counts, seen = traced_run
    assert counts["forest.steps"] == len(steps)
    assert 0 < counts["forest.attempt_steps"] < len(steps)
    assert counts["forest.attempt_steps"] == seen["attempt_steps"]
    for name in ATTEMPT_STAGES:
        per_step = [len([iv for iv in found[name] if inside(iv, [u])])
                    for u in found["forest.update"]]
        assert set(per_step) <= {0, 1}, name
        assert sum(per_step) == counts["forest.attempt_steps"], name


def test_counters_match_the_states(traced_run):
    cfg, _, _, steps, found, counts, seen = traced_run
    swaps = int(steps[-1][0]["resets"].sum())
    assert swaps > 0, "the stream never swapped a member"
    assert counts["forest.swaps"] == swaps == len(found["forest.swap"])
    assert counts["forest.swaps"] == sum(int(a["drift"].any()) for _, a in steps)
    assert counts["forest.splits"] == seen["splits"] > 0
    assert counts["forest.attempted_leaves"] == seen["attempted"]
    assert counts["forest.splits"] <= counts["forest.attempted_leaves"]
    # on a step that swaps nobody the trees only grow, two nodes a split
    growth = 0
    prev = tfr.init_forest(cfg, 0, device="cpu")["trees"]["n_nodes"]
    for state, aux in steps:
        n = state["trees"]["n_nodes"]
        if not bool(aux["drift"].any()):
            growth += int((n - prev).sum())
        prev = n
    assert growth % 2 == 0 and 0 < growth // 2 <= counts["forest.splits"]


def test_serve_spans_and_counters():
    cfg = config("qo")
    X, y = stream()
    state = tfr.init_forest(cfg, 0, device="cpu")
    for i in range(0, 1000, B):
        state, _ = tfr.update(cfg, state, X[i:i + B], y[i:i + B], device="cpu")
    snap = tsv.freeze(state, device="cpu")
    sizes = (1, 7, 64)
    answers, found, counts = profiled(
        lambda: [tsv.predict_snapshot(snap, X[:s], device="cpu") for s in sizes])
    assert [a.shape[0] for a in answers] == list(sizes)
    assert counts == {"serve.requests": 3, "serve.rows": sum(sizes)}
    outer = found["serve.predict_snapshot"]
    assert len(outer) == 3
    for name in SERVE_STAGES:
        assert len(found[name]) == 3
        for iv in found[name]:
            assert len(inside(iv, outer)) == 1, name
    assert not any(k.startswith("forest.") for k in found)


@pytest.mark.parametrize("observer", OBSERVERS)
def test_nothing_recorded_or_counted_without_a_profiler(observer, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg = config(observer)
    X, y = stream()
    spans.reset_counts()
    steps = learn(cfg, X, y)
    snap = tsv.freeze(steps[-1][0], device="cpu")
    tsv.predict_snapshot(snap, X[:5], device="cpu")
    assert spans.counts() == {}
    assert int(steps[-1][0]["resets"].sum()) > 0


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("observer", OBSERVERS)
def test_states_bitwise_equal_with_the_profiler_on_and_off(observer):
    cfg = config(observer)
    X, y = stream()
    off = learn(cfg, X, y)
    on = profiled(lambda: learn(cfg, X, y))[0]
    for (s0, a0), (s1, a1) in zip(off, on):
        f0, f1 = flat({"state": s0, "aux": a0}), flat({"state": s1, "aux": a1})
        assert f0.keys() == f1.keys()
        for k in f0:
            assert torch.equal(f0[k], f1[k]), k


def test_trace_writes_the_counters_beside_the_trace(tmp_path):
    cfg = config("qo")
    X, y = stream()
    state = tfr.init_forest(cfg, 0, device="cpu")
    # an earlier profiled step: the trace starts its counters afresh
    state, _ = profiled(lambda: tfr.update(cfg, state, X[:B], y[:B],
                                           device="cpu"))[0]
    assert profile.counts()["forest.steps"] == 1
    with profile.trace(str(tmp_path)):
        for i in range(B, 4 * B, B):
            state, _ = tfr.update(cfg, state, X[i:i + B], y[i:i + B],
                                  device="cpu")
    traces = sorted(tmp_path.glob("trace_*.json"))
    counters = sorted(tmp_path.glob("counters_*.json"))
    assert len(traces) == len(counters) == 1
    assert counters[0].name[len("counters_"):] == traces[0].name[len("trace_"):]
    got = json.loads(counters[0].read_text())
    assert got["forest.steps"] == 3
    assert got == profile.counts()
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"forest.update", *LEARN_STAGES} <= names
