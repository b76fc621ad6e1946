"""The readers of the program's stage spans and counters: each one's
arithmetic on synthetic Chrome events and stubbed counters, and the
cases in which it reports nothing."""
import types

import pytest

from harness import spec, trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def events():
    """A 1 ms window: two steps, one attempting a split (query 40 us,
    decide 10 us, apply 30 us) and both swapping (swaps 100 and 60 us);
    device-side annotations and operators of the same names do not
    count."""
    return [
        X("perfbench.window", "user_annotation", 0, 1000),
        X("forest.update", "user_annotation", 10, 400),
        X("forest.attempt", "user_annotation", 20, 200),
        X("forest.query", "user_annotation", 30, 40),
        X("forest.decide", "user_annotation", 80, 10),
        X("forest.apply", "user_annotation", 100, 30),
        X("forest.swap", "user_annotation", 300, 100),
        X("forest.update", "user_annotation", 500, 400),
        X("forest.attempt", "user_annotation", 510, 20),
        X("forest.swap", "user_annotation", 700, 60),
        X("forest.query", "gpu_user_annotation", 40, 500),
        X("forest.swap", "cpu_op", 710, 10),
        X("forest.query", "user_annotation", 5000, 40),           # after the window
    ]


def ctx(kind="learn", evs=None):
    return types.SimpleNamespace(kind=kind, trace=trace.parse(evs or events()))


@pytest.fixture
def counts(monkeypatch):
    from repro_torch.perf import profile
    box = {}
    monkeypatch.setattr(profile, "counts", lambda: dict(box))
    return box


def read(name):
    return spec.reader(name)


def test_host_ms_per_attempt_step(counts):
    counts.update({"forest.steps": 2, "forest.attempt_steps": 1})
    assert read("split_attempt.host_ms_per_attempt_step")(ctx()) == pytest.approx(0.080)
    counts["forest.attempt_steps"] = 4
    assert read("split_attempt.host_ms_per_attempt_step")(ctx()) == pytest.approx(0.020)


def test_split_yield(counts):
    counts.update({"forest.attempted_leaves": 8, "forest.splits": 6})
    assert read("split_attempt.split_yield")(ctx()) == pytest.approx(75.0)
    counts["forest.splits"] = 0
    assert read("split_attempt.split_yield")(ctx()) == 0.0


def test_host_ms_per_swap_step(counts):
    counts.update({"forest.swaps": 2})
    assert read("drift_swap.host_ms_per_swap_step")(ctx()) == pytest.approx(0.080)


@pytest.mark.parametrize("name,keys", [
    ("split_attempt.host_ms_per_attempt_step", ("forest.attempt_steps",)),
    ("split_attempt.split_yield", ("forest.attempted_leaves", "forest.splits")),
    ("drift_swap.host_ms_per_swap_step", ("forest.swaps",)),
])
def test_nothing_without_attempts_swaps_or_spans(counts, name, keys):
    r = read(name)
    counts.update({"forest.steps": 2})
    assert r(ctx()) is None                    # nothing attempted or swapped
    counts.update({k: 0 for k in keys})
    assert r(ctx()) is None
    counts.update({k: 3 for k in keys})
    assert r(ctx("serve")) is None             # not a learn window
    if name != "split_attempt.split_yield":    # counted, but no span recorded
        assert r(ctx(evs=events()[:1])) is None


@pytest.mark.parametrize("name", ["split_attempt.host_ms_per_attempt_step",
                                  "split_attempt.split_yield",
                                  "drift_swap.host_ms_per_swap_step"])
def test_nothing_from_a_program_without_counters(monkeypatch, name):
    from repro_torch.perf import profile
    monkeypatch.delattr(profile, "counts")
    assert read(name)(ctx()) is None
