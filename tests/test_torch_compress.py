"""Port parity: QO-thresholded gradient sparsification with error feedback
(``repro_torch.optim.compress.sparsify_with_sketch``) against the JAX
package's ``repro.optim.compress`` on the same numpy gradients.

Per step the port's error state feeds both.  The threshold (the
reference's, recomputed from its public ``qo`` and ``sketch``
functions) within 1e-4 relative; the masks equal except for elements
within that distance of the threshold; ``g + e == sparse + new_e``
exactly; the density within the share of such elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qo as rqo
from repro.core import sketch as rsk
from repro.optim import compress as rcomp
from repro_torch.optim import compress as tcomp

TOL = 1e-4


def grads(rng):
    return {"attn": {"q": rng.normal(0, 1, (64, 48)).astype(np.float32),
                     "norm": rng.normal(1, 0.1, (48,)).astype(np.float32)},
            "mlp": rng.standard_t(3, (96, 32)).astype(np.float32)}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def ref_threshold(g, keep_frac, bins=256):
    """The reference's per-leaf threshold, step for step."""
    flat = jnp.abs(g).reshape(-1)
    sig = jnp.maximum(jnp.std(flat), 1e-12)
    table = dict(rqo.init(bins, radius=1.0, origin=0.0), radius=sig / 2.0,
                 origin=jnp.mean(flat))
    table = rqo.update(table, flat, flat)
    return float(rsk.quantile(table, jnp.asarray(1.0 - keep_frac)))


@pytest.mark.parametrize("keep_frac", [0.05, 0.2])
def test_matches_reference_over_three_steps(keep_frac):
    rng = np.random.default_rng(int(keep_frac * 100))
    err = tcomp.init_error_state(jax.tree.map(torch.as_tensor, grads(rng)))
    ref = jax.jit(lambda g, e: rcomp.sparsify_with_sketch(
        g, e, keep_frac=keep_frac))
    for _ in range(3):
        g_np = grads(rng)
        g_t = jax.tree.map(torch.as_tensor, g_np)
        sp, ne, m = tcomp.sparsify_with_sketch(g_t, err, keep_frac=keep_frac)
        e_tree = jax.tree.map(lambda a: a.numpy(), err)
        rsp, rne, rm = ref(g_np, e_tree)
        near = 0
        total = 0
        for (name, gl), (_, el), (_, sl), (_, nl), (_, rsl), (_, rnl) in zip(
                leaves(g_np), leaves(e_tree), leaves(sp), leaves(ne),
                leaves(rsp), leaves(rne)):
            acc = gl + el
            thr_t = float(tcomp.sketch_threshold(torch.as_tensor(acc),
                                                 keep_frac))
            thr_r = ref_threshold(jnp.asarray(acc), keep_frac)
            np.testing.assert_allclose(thr_t, thr_r, rtol=TOL, err_msg=name)
            mask_t = sl.numpy() != 0
            mask_r = np.asarray(rsl) != 0
            close = np.abs(np.abs(acc) - thr_r) <= TOL * abs(thr_r)
            assert not (mask_t != mask_r)[~close].any(), name
            near += int(close.sum())
            total += acc.size
            # g + e == sparse + new_e, exactly
            np.testing.assert_array_equal(sl.numpy() + nl.numpy(), acc)
            np.testing.assert_array_equal(np.asarray(rsl) + np.asarray(rnl),
                                          acc)
            np.testing.assert_array_equal(sl.numpy()[~close],
                                          np.asarray(rsl)[~close])
        assert abs(float(m["density"]) - float(rm["density"])) \
            <= near / total + 1e-6
        err = ne
    assert 0.0 < float(m["density"]) < 1.0


def test_sparsify_keeps_top_fraction():
    """The reference's own test (``tests/test_compress.py``)."""
    rng = np.random.default_rng(0)
    g = {"a": torch.as_tensor(rng.normal(0, 1, (64, 64)).astype(np.float32)),
         "b": torch.as_tensor(rng.normal(0, 3, (128,)).astype(np.float32))}
    err = tcomp.init_error_state(g)
    sparse, new_err, m = tcomp.sparsify_with_sketch(g, err, keep_frac=0.1)
    assert 0.02 < float(m["density"]) < 0.35
    a = sparse["a"].numpy()
    kept = np.abs(a)[a != 0]
    assert kept.min() >= np.abs((g["a"] - sparse["a"]).numpy()).max() * 0.5


def test_error_feedback_is_lossless_over_time():
    rng = np.random.default_rng(1)
    g = torch.as_tensor(rng.normal(0, 1, (256,)).astype(np.float32))
    err = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(5):
        sparse, err, _ = tcomp.sparsify_with_sketch({"g": g}, {"g": err},
                                                    keep_frac=0.2)
        sparse, err = sparse["g"], err["g"]
        sent = sent + sparse
    np.testing.assert_allclose((sent + err).numpy(), (5 * g).numpy(),
                               rtol=1e-4, atol=1e-4)
