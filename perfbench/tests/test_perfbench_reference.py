"""The plain reference agrees with the port's CPU path at a small size,
and refuses the control and the faults a cell can have."""
import time

import pytest
import torch

from conftest import LEARN, SERVE, run_small, small_cell


@pytest.mark.parametrize("workload", LEARN + SERVE)
def test_port_cpu_path_is_correct(workload):
    res = run_small(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_judged_steps_split_and_swap():
    """The judged steps cover splits (the start) and the comparison sees
    them; the drifting stream swaps members at its third concept change
    (batch 120; at B = 256 the error windows are too noisy to signal)."""
    from harness import learn
    c = small_cell(LEARN[0])
    c.config.update(batch_rows=1024)
    c.traffic.update(check_every=1, max_checks=5, warm_batches=118, pool_batches=130)
    out = learn.run(c, 5, 0.6, False, "cpu", time.time())
    assert sum(r["splits"] for r in out["readings"]) > 0
    assert sum(r["swaps"] for r in out["readings"]) > 0
    assert all(r["route_mismatch"] == 0 and r["choice_mismatch"] == 0
               for r in out["readings"])


@pytest.mark.parametrize("workload", LEARN + SERVE)
def test_control_fails(workload):
    """The reference computed in bfloat16, in the program's place."""
    import run as bench
    from harness import learn, serve
    c = small_cell(workload)
    control = []
    mod = learn if c.traffic["kind"] == "learn" else serve
    mod.run(c, 7, 0.5, False, "cpu", time.time(), control)
    ok, failed, checks = bench.verdict(control, bench.limits_of(workload))
    assert not ok and failed == len(control), checks


def _update_unchanged(orig):
    from harness import port

    def update(fcfg, state, X, y, bw, nm, dev):
        _, aux = orig(fcfg, port.clone(state), X, y, bw, nm, dev)
        return state, aux
    return update


def _update_half(orig):
    def update(fcfg, state, X, y, bw, nm, dev):
        h = X.shape[0] // 2
        return orig(fcfg, state, X[:h], y[:h], bw[:, :h], nm, dev)
    return update


def _update_altered(orig):
    def update(fcfg, state, X, y, bw, nm, dev):
        state, aux = orig(fcfg, state, X, y, bw, nm, dev)
        return state, dict(aux, forest_mse=aux["forest_mse"] * 1.01)
    return update


@pytest.mark.parametrize("workload", LEARN)
@pytest.mark.parametrize("fault", [_update_unchanged, _update_half, _update_altered])
def test_learn_faults_fail(monkeypatch, workload, fault):
    from harness import port
    monkeypatch.setattr(port, "update", fault(port.update))
    res = run_small(workload)
    assert not res["correct"], res["checks"]


def test_serve_altered_answer_fails(monkeypatch):
    from harness import port
    orig = port.predict_snapshot

    def predict(snap, X, device):
        out = orig(snap, X, device).clone()
        out[0] *= 1.01
        return out
    monkeypatch.setattr(port, "predict_snapshot", predict)
    res = run_small(SERVE[0])
    assert not res["correct"], res["checks"]


def test_serve_half_answers_fail(monkeypatch):
    from harness import port
    orig = port.predict_snapshot
    monkeypatch.setattr(port, "predict_snapshot",
                        lambda snap, X, device: orig(snap, X[: max(1, len(X) // 2)], device))
    res = run_small(SERVE[0])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", LEARN + SERVE)
def test_carried_comparison_reproduces_the_window(workload):
    """The program's rerun from an empty forest reaches the state the
    window started from (or the snapshot was frozen from) bit for bit,
    and the window's first steps' errors."""
    import run as bench
    info = {}
    res = bench.run_cell(small_cell(workload), 2 ** 31 + 29, 0.5, False, "cpu",
                         time.time(), bench.limits_of(workload), info)
    assert res["correct"], res["checks"]
    assert info["start_equal"] is True
    assert info["window_steps_equal"] == info["window_steps_compared"]
    if workload in LEARN:
        assert info["window_steps_compared"] > 0


def _setup_only_fault(orig, nth):
    """A fault in the ``nth`` batch of the pool only (the set-up's, where
    no window step is judged): the leaves' target means move by 5 %."""
    from harness import port
    seen = []

    def update(fcfg, state, X, y, bw, nm, dev):
        if X.data_ptr() not in seen:
            seen.append(X.data_ptr())
        state, aux = orig(fcfg, state, X, y, bw, nm, dev)
        if seen.index(X.data_ptr()) == nth:
            state = port.clone(state)
            state["trees"]["ystats"]["mean"] *= 1.05
        return state, aux
    return update


@pytest.mark.parametrize("workload", (LEARN[0], SERVE[0]))
def test_carried_comparison_catches_a_setup_fault(monkeypatch, workload):
    from harness import port
    monkeypatch.setattr(port, "update", _setup_only_fault(port.update, 3))
    res = run_small(workload)
    assert not res["correct"], res["checks"]
    assert res["checks"]["state_err"]["value"] > 1e-2


def test_adopt_rounding_takes_only_rounding_level_values():
    from harness import check
    mine = {"a": torch.tensor([1.0, 2.0, 0.0, 5.0]), "n": torch.tensor([1, 2])}
    prog = {"a": torch.tensor([1.0 + 1e-7, 2.1, 1e-9, 5.0]), "n": torch.tensor([1, 3])}
    out = check.adopt_rounding(mine, prog)
    assert out["a"].tolist() == [prog["a"][0].item(), 2.0, prog["a"][2].item(), 5.0]
    assert out["n"].tolist() == [1, 2]


def test_window_checks_cover_phases_and_concept_changes():
    """Regular checks fall on distinct phases of the 120-batch swap cycle,
    and on the drifting stream on the first step of consecutive concept
    changes."""
    from harness import learn, spec
    t = spec.load(LEARN[0]).traffic
    per, warm = t["period_batches"], t["warm_batches"]
    for seed in (1, 2 ** 31 + 3, 987654321):
        due = learn.window_checks(t, seed)
        s = sorted(k + warm for k in due)
        changes = [x for x in s if x % per == 0 and x >= t["carry_steps"]]
        assert len(changes) >= t["change_checks"]
        cs = sorted({x // per for x in changes})
        assert any(cs[i + 2] - cs[i] == 2 for i in range(len(cs) - 2))
        assert len({k % 120 for k in due}) >= t["max_checks"]


def test_batch_weight_check_holds_past_float32_integers():
    """A leaf that has learned over 2**24 rows' weight: its count rounds
    in float32 on both sides, and the comparison must not read that
    rounding as a lost row."""
    from harness import check, learn, port
    loop = learn.Loop(small_cell(LEARN[2]), 41, "cpu")
    for _ in range(4):
        loop.step()
    loop.state["trees"]["ystats"]["n"] += float(2 ** 24 + 1)
    pre = port.clone(loop.state)
    X, y, bw, nm = loop.batch(loop.pos)
    post, aux = port.update(loop.fcfg, port.clone(pre), X, y, bw, nm, "cpu")
    leaf = port.route(pre, X, loop.cfg["max_depth"])
    r, _ = check.compare_step(loop.cfg, pre, pre, post, aux, X, y, bw, nm, leaf)
    assert r["route_mismatch"] == 0 and r["choice_mismatch"] == 0, r
    # the case is real: a difference of the counts misses the batch weight
    from reference import arf
    batch_n = arf.prepare(loop.cfg, pre, X, y, bw)["batch_n"]
    dn = post["trees"]["ystats"]["n"] - pre["trees"]["ystats"]["n"]
    assert bool(((dn != batch_n) & pre["trees"]["is_leaf"]).any())
