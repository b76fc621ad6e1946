"""Port parity: QO telemetry (``repro_torch.train.monitor``) against the
JAX package's ``repro.train.monitor`` on the same series of step
scalars: the three QO tables within 1e-4 after every step, the straggler
and loss-spike alerts equal at every step, the summaries within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import monitor as rmon
from repro_torch.train import monitor as tmon

TOL = 1e-4


def series(n=200, seed=0):
    """Losses drifting down with noise, grad norms near 1, step times near
    1 s; a straggler at step 120 and a loss spike at step 150."""
    rng = np.random.default_rng(seed)
    loss = (5.0 - 0.005 * np.arange(n) + 0.05 * rng.normal(0, 1, n))
    grad = 1.0 + 0.05 * rng.normal(0, 1, n)
    step = 1.0 + 0.02 * rng.normal(0, 1, n)
    step[120] = 4.0
    loss[150] = 40.0
    return [np.float32(a) for a in (loss, grad, step)]


def assert_tables_close(t, r):
    np.testing.assert_array_equal(t["y"]["n"].numpy(),
                                  np.asarray(r["y"]["n"]))
    for k in ("mean", "m2"):
        np.testing.assert_allclose(t["y"][k].numpy(), np.asarray(r["y"][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(t["sum_x"].numpy(), np.asarray(r["sum_x"]),
                               rtol=TOL, atol=TOL)


def test_series_matches_reference():
    loss, grad, step = series()
    r = rmon.init_monitor()
    t = tmon.init_monitor(device="cpu")
    r_obs = jax.jit(lambda m, a, b, c: rmon.observe(
        m, loss=a, grad_norm=b, step_time=c))
    r_str = jax.jit(rmon.is_straggler)
    r_spk = jax.jit(rmon.loss_spike)
    fired = []
    for i in range(loss.shape[0]):
        s_r = bool(r_str(r, jnp.float32(step[i])))
        s_t = bool(tmon.is_straggler(t, step[i]))
        k_r = bool(r_spk(r, jnp.float32(loss[i])))
        k_t = bool(tmon.loss_spike(t, loss[i]))
        assert (s_t, k_t) == (s_r, k_r), f"step {i}"
        if s_t or k_t:
            fired.append((i, s_t, k_t))
        r = r_obs(r, jnp.float32(loss[i]), jnp.float32(grad[i]),
                  jnp.float32(step[i]))
        t = tmon.observe(t, loss=loss[i], grad_norm=grad[i],
                         step_time=step[i])
        for name in tmon.SIGNALS:
            assert_tables_close(t[name], r[name])
    assert (120, True, False) in fired and (150, False, True) in fired
    st, sr = tmon.summaries(t), rmon.summaries(r)
    for name in tmon.SIGNALS:
        for key, v in sr[name].items():
            np.testing.assert_allclose(float(st[name][key]), float(v),
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{name}/{key}")


def test_monitor_observe_and_alerts():
    """The reference's own alert test (``tests/test_sketch_monitor.py``)."""
    mon = tmon.init_monitor(device="cpu")
    for i in range(100):
        mon = tmon.observe(mon, loss=5.0 + 0.01 * i, grad_norm=1.0,
                           step_time=1.0)
    assert not bool(tmon.loss_spike(mon, 5.5))
    assert bool(tmon.loss_spike(mon, 50.0))
    assert not bool(tmon.is_straggler(mon, 1.0))
    assert bool(tmon.is_straggler(mon, 10.0))
    s = tmon.summaries(mon)
    assert abs(float(s["step_time"]["mean"]) - 1.0) < 1e-3
    assert float(s["loss"]["count"]) == 100


def test_no_alert_before_min_n(monkeypatch):
    mon = tmon.init_monitor(device="cpu")
    for _ in range(31):
        mon = tmon.observe(mon, loss=1.0, step_time=1.0)
    assert not bool(tmon.is_straggler(mon, 100.0))
    assert not bool(tmon.loss_spike(mon, 100.0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmon.init_monitor()
