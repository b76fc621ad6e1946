"""Port parity: the single-table QO observer (``repro_torch.core.qo``, the
``qo_update`` / ``qo_best_split`` ops and their kernel modules) and the
paper's §5.1 stream protocol.

The same numpy inputs go through the JAX package -- ``core/qo.py`` (one
segment reduction, the associative-scan query) and ``ops.qo_update`` /
``ops.qo_best_split`` with ``interpret=True`` (the Pallas kernel bodies)
-- and through the port on the CPU (the kernels' plain versions).  Counts
must match exactly (integer weights); other statistics, merits and
thresholds within 1e-4 (``tests/test_qo_batched.py``'s tolerance); -inf
patterns and validity exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qo as jqo
from repro.core import stats as jstats
from repro.data import synth as jsynth
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.qo_query import qo_query_pallas
from repro_torch.core import qo as tqo
from repro_torch.core import stats as tstats
from repro_torch.data import synth
from repro_torch.kernels import qo_query

TOL = 1e-4


def jax_table(t):
    """A port table (torch) as the reference's (jnp) table."""
    return {"radius": jnp.asarray(t["radius"].numpy()),
            "origin": jnp.asarray(t["origin"].numpy()),
            "sum_x": jnp.asarray(t["sum_x"].numpy()),
            "y": {k: jnp.asarray(v.numpy()) for k, v in t["y"].items()}}


def assert_table_holds(port, ref, what=""):
    np.testing.assert_array_equal(port["y"]["n"].numpy(),
                                  np.asarray(ref["y"]["n"]), err_msg=what)
    for k in ("mean", "m2"):
        np.testing.assert_allclose(port["y"][k].numpy(),
                                   np.asarray(ref["y"][k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}{k}")
    np.testing.assert_allclose(port["sum_x"].numpy(),
                               np.asarray(ref["sum_x"]), rtol=TOL, atol=TOL,
                               err_msg=f"{what}sum_x")


def random_table(rng, C, radius=0.1, origin=0.0, n=300):
    """A table that already holds one weighted batch."""
    t = tqo.init(C, radius, origin, device="cpu")
    x = rng.normal(origin, 4 * radius * C ** 0.5 / 4, n).astype(np.float32)
    return tqo.update(t, x, rng.normal(0, 1, n).astype(np.float32),
                      rng.integers(0, 4, n).astype(np.float32),
                      device="cpu")


@pytest.mark.parametrize("B,C", [(1, 64), (37, 64), (1500, 256)])
def test_update_matches_reference_both_paths(B, C):
    rng = np.random.default_rng(B + C)
    t = random_table(rng, C, radius=0.05, origin=0.2)
    x = rng.normal(0.2, 1.0, B).astype(np.float32)
    y = rng.normal(1.0, 2.0, B).astype(np.float32)
    w = rng.integers(0, 5, B).astype(np.float32)
    port = tqo.update(t, x, y, w, device="cpu")
    jt = jax_table(t)
    core = jqo.update(jt, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    kern = jops.qo_update(jt, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(w), interpret=True)
    assert_table_holds(port, core, "core: ")
    assert_table_holds(port, kern, "interpret: ")
    assert float(port["y"]["n"].sum()) == float(t["y"]["n"].sum()) \
        + float(w.sum())
    # the input table is left as it was (out of place)
    assert_table_holds(t, jt)


def test_update_bins_extreme_x_like_the_reference():
    """ROADMAP C1 on the single table: 1e10 and +inf land in bin 0, NaN in
    bin C/2, -inf and -1e10 in bin 0."""
    C = 64
    x = np.array([1e10, np.inf, -np.inf, np.nan, -1e10, 3e9, 0.5, -0.5,
                  40.0, -40.0, 0.0, -0.0], np.float32)
    y = np.arange(len(x), dtype=np.float32)
    t = tqo.init(C, 1.0, device="cpu")
    port = tqo.update(t, x, y, device="cpu")
    jt = jax_table(t)
    for ref in (jqo.update(jt, jnp.asarray(x), jnp.asarray(y)),
                jops.qo_update(jt, jnp.asarray(x), jnp.asarray(y),
                               interpret=True)):
        np.testing.assert_array_equal(port["y"]["n"].numpy(),
                                      np.asarray(ref["y"]["n"]))
        for k in ("mean", "m2"):
            np.testing.assert_allclose(port["y"][k].numpy(),
                                       np.asarray(ref["y"][k]), rtol=TOL,
                                       atol=TOL)
    n = port["y"]["n"].numpy()
    # bin 0: 1e10, inf, -inf, -1e10, 3e9, -40; bin C/2: nan, 0.5, +-0.0
    assert n[0] == 6 and n[C // 2] == 4
    sx = port["sum_x"].numpy()
    assert np.isnan(sx[C // 2]) and np.isnan(sx[0])
    np.testing.assert_allclose(port["sum_x"].numpy(),
                               np.asarray(jqo.update(jt, jnp.asarray(x),
                                                     jnp.asarray(y))["sum_x"]),
                               rtol=TOL, atol=TOL)


def split_both(t):
    """(port, core, interpret) split results of the same table."""
    jt = jax_table(t)
    port = tqo.best_split(t, device="cpu")
    return port, jqo.best_split(jt), jops.qo_best_split(jt, interpret=True)


def assert_split_holds(port, ref, what=""):
    assert bool(port.valid) == bool(ref.valid), what
    np.testing.assert_allclose(float(port.merit), float(ref.merit),
                               rtol=TOL, atol=TOL, err_msg=what)
    np.testing.assert_allclose(float(port.threshold), float(ref.threshold),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("C,occupied", [(32, 0), (32, 1), (64, 2),
                                        (256, 40), (256, 256)])
def test_best_split_matches_reference(C, occupied):
    rng = np.random.default_rng(C + occupied)
    t = tqo.init(C, 1.0, device="cpu")
    bins = rng.choice(C, occupied, replace=False)
    n = np.zeros(C, np.float32)
    n[bins] = rng.integers(1, 9, occupied)
    t["y"]["n"] = torch.tensor(n)
    t["y"]["mean"] = torch.tensor(np.where(n > 0, rng.normal(0, 3, C), 0)
                                  .astype(np.float32))
    t["y"]["m2"] = torch.tensor(np.where(n > 1, rng.uniform(0, 2, C), 0)
                                .astype(np.float32))
    t["sum_x"] = torch.tensor((n * (np.arange(C) + rng.uniform(0, 1, C)))
                              .astype(np.float32))
    port, core, kern = split_both(t)
    assert bool(port.valid) == (occupied >= 2)
    assert_split_holds(port, core, "core")
    assert_split_holds(port, kern, "interpret")

    # the (C,) score and threshold rows against the Pallas kernel's rows
    dense, _ = jref.pack_table(jax_table(t))
    rows = np.asarray(qo_query_pallas(dense, interpret=True))
    score, cand = qo_query.scores_plain(t["y"]["n"], t["y"]["mean"],
                                        t["y"]["m2"], t["sum_x"])
    np.testing.assert_array_equal(np.isneginf(score.numpy()),
                                  np.isneginf(rows[0]))
    fin = np.isfinite(rows[0])
    np.testing.assert_allclose(score.numpy()[fin], rows[0][fin], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cand.numpy(), rows[1], rtol=TOL, atol=TOL)


def test_argmax_takes_the_first_nan_then_the_first_maximum():
    s = torch.tensor([[1.0, 3.0, 3.0, float("-inf")],
                      [1.0, float("nan"), 5.0, float("nan")],
                      [float("-inf")] * 4])
    assert qo_query.argmax_nan_first(s).tolist() == [1, 1, 0]
    np.testing.assert_array_equal(
        qo_query.argmax_nan_first(s).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(s.numpy()), -1)))


def test_merge_total_slots_and_radius_match_reference():
    rng = np.random.default_rng(3)
    a, b = random_table(rng, 64), random_table(rng, 64)
    merged = tqo.merge_tables(a, b)
    assert_table_holds(merged, jqo.merge_tables(jax_table(a), jax_table(b)))
    for t in (a, merged):
        tot, ref = tqo.total_stats(t), jqo.total_stats(jax_table(t))
        for k in ("n", "mean", "m2"):
            np.testing.assert_allclose(float(tot[k]), float(ref[k]),
                                       rtol=TOL, atol=TOL)
        assert int(tqo.n_slots(t)) == int(jqo.n_slots(jax_table(t)))
    x = rng.lognormal(0, 1, 5000).astype(np.float32)
    r, o = tqo.auto_radius(x, k=2.0)
    jr, jo = jqo.auto_radius(jnp.asarray(x), 64, 2.0)
    np.testing.assert_allclose([float(r), float(o)], [float(jr), float(jo)],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_tree_reduce_merge_matches_reference(k):
    rng = np.random.default_rng(k)
    s = {"n": rng.integers(0, 5, (k, 3)).astype(np.float32),
         "mean": rng.normal(0, 1, (k, 3)).astype(np.float32),
         "m2": rng.uniform(0, 1, (k, 3)).astype(np.float32)}
    s["mean"][s["n"] == 0] = 0
    s["m2"][s["n"] == 0] = 0
    port = tstats.tree_reduce_merge({kk: torch.tensor(v.T)
                                     for kk, v in s.items()}, dim=1)
    ref = jstats.tree_reduce_merge({kk: jnp.asarray(v)
                                    for kk, v in s.items()}, axis=0)
    for kk in ("n", "mean", "m2"):
        np.testing.assert_allclose(port[kk].numpy(), np.asarray(ref[kk]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dist,variant,task", [
    ("normal", 0, "lin"), ("uniform", 2, "cub"), ("bimodal", 1, "lin"),
    ("bimodal", 2, "cub")])
def test_paper_stream_is_the_reference_stream_and_splits_alike(dist, variant,
                                                               task):
    """§5.1: the same stream in both packages, absorbed at the paper's
    radius sigma/2 (``auto_radius``, k = 2) into a C = 256 table."""
    cfg = synth.SynthConfig(dist=dist, variant=variant, task=task,
                            noise_frac=0.1, n=synth.SAMPLE_SIZES[8], seed=4)
    x, y = synth.generate(cfg)
    jx, jy = jsynth.generate(jsynth.SynthConfig(**vars(cfg)))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert synth.DISTRIBUTIONS == jsynth.DISTRIBUTIONS
    assert synth.SAMPLE_SIZES == jsynth.SAMPLE_SIZES
    r, o = tqo.auto_radius(x, k=2.0)
    t = tqo.update(tqo.init(256, float(r), float(o), device="cpu"), x, y,
                   device="cpu")
    jt = jqo.update(jqo.init(256, float(r), float(o)), jnp.asarray(x),
                    jnp.asarray(y))
    assert_table_holds(t, jt)
    port, ref = tqo.best_split(t, device="cpu"), jqo.best_split(jt)
    assert bool(port.valid)
    assert_split_holds(port, ref)


def test_quickstart_stream_finds_the_planted_split():
    """``examples/quickstart.py``'s stream: a step at x = 0.3."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 20_000).astype(np.float32)
    y = np.where(x <= 0.3, 1.0, 6.0).astype(np.float32) + \
        0.1 * rng.normal(0, 1, 20_000).astype(np.float32)
    t = tqo.update(tqo.init(256, 0.03, float(np.mean(x)), device="cpu"), x,
                   y, device="cpu")
    split = tqo.best_split(t, device="cpu")
    assert abs(float(split.threshold) - 0.3) < 0.1
    assert_split_holds(split, jqo.best_split(jax_table(t)))
