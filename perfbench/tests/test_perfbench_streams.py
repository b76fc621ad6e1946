"""The traffic generator repeats per seed and drifts where it says."""
import numpy as np
import torch

from conftest import small_cell, LEARN, SERVE


def _pool(workload, seed, **traffic):
    from harness import streams
    c = small_cell(workload)
    c.traffic.update(traffic)
    return c, streams.learn_pool(c.config, c.traffic, seed, "cpu")


def test_pool_repeats_per_seed_and_differs_across_seeds():
    _, a = _pool(LEARN[0], 2 ** 31 + 5)
    _, b = _pool(LEARN[0], 2 ** 31 + 5)
    _, c = _pool(LEARN[0], 2 ** 31 + 6)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["X"], c["X"])


def test_pool_shapes_and_draws():
    c, p = _pool(LEARN[0], 3)
    P, B, F, T = 40, c.config["batch_rows"], c.config["n_features"], c.config["n_trees"]
    assert p["X"].shape == (P, B, F) and p["y"].shape == (P, B)
    assert p["bag_w"].shape == (P, T, B) and p["masks"].shape == (P, T, F)
    assert bool((p["bag_w"] == p["bag_w"].round()).all())
    assert abs(float(p["bag_w"].mean()) - c.config["lam"]) < 0.2
    k = round(c.config["subspace"] * F)
    assert bool((p["masks"].sum(-1) == k).all()) and int(p["mask0"].sum(-1)[0]) == k


def test_gra_moves_the_relevant_features_at_the_period():
    from harness import streams
    c, p = _pool(LEARN[0], 11, noise_sd=0.0, pool_batches=81)
    period = c.traffic["period_batches"]
    assert period * 4096 == 163840
    x = p["X"]
    for i in (period - 1, period, 2 * period):
        a = streams.friedman1(x[i], torch.tensor(0), torch.zeros(()))
        b = streams.friedman1(x[i], torch.tensor(1), torch.zeros(()))
        want = a if (i // period) % 2 == 0 else b
        other = b if (i // period) % 2 == 0 else a
        assert torch.allclose(p["y"][i], want, atol=1e-5), i
        assert not torch.allclose(p["y"][i], other, atol=1e-2), i


def test_cauchy_map_is_monotone_and_keeps_y():
    _, u = _pool(LEARN[0], 21)
    _, ca = _pool(LEARN[1], 21)
    assert torch.equal(u["y"], ca["y"])
    x = u["X"][0, :, 0]
    order = torch.argsort(x)
    assert bool((ca["X"][0, :, 0][order].diff() >= 0).all())


def test_request_sizes_same_multiset_new_order():
    from harness import streams
    t = small_cell(SERVE[0]).traffic
    a, b = streams.request_rows(t, 1), streams.request_rows(t, 2)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= 1 and a.max() <= t["request_rows_max"]
    assert np.array_equal(streams.request_rows(t, 1), a)
