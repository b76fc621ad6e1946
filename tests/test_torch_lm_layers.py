"""The port's LM layers: bf16 compute against the reference, the
float32-output products, and the reference's own model properties held
on the port (``tests/test_models_smoke.py`` and ``tests/test_ssm.py``).

bf16: ``lm_loss`` of each architecture in bf16 compute on both sides,
within 2e-3 relative (a quarter of bf16's 2^-7 spacing; the two compilers
round the same products in different places, measured up to 4.2e-4).  The
JAX CPU backend cannot execute a batched bf16 x bf16 -> float32 dot whose
batch axis is not leading (the MoE expert products, "UNIMPLEMENTED ...
DotThunk"), so for the MoE architectures the reference's ``jnp.einsum``
is wrapped to upcast its bf16 operands to float32 first: bf16 values are
exact in float32 and both products accumulate in float32, so it is the
same function.  The reference's files are untouched.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT

from test_torch_lm_models import B, KV, assert_close, flat, reference, \
    torch_batch

ARCHS = sorted(RC.ARCHS)
BF16_TOL = 2e-3


@pytest.fixture
def f32_compute():
    TL.set_compute_dtype(torch.float32)
    yield
    TL.set_compute_dtype(torch.bfloat16)


@pytest.fixture
def bf16_compute(monkeypatch):
    RL.set_compute_dtype(jnp.bfloat16)
    TL.set_compute_dtype(torch.bfloat16)
    yield monkeypatch
    RL.set_compute_dtype(jnp.float32)


def _upcasting_jnp():
    """``jax.numpy`` whose einsum upcasts bf16 operands of a
    float32-output product (see the module docstring)."""
    def einsum(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o
                   for o in ops]
        return jnp.einsum(eq, *ops,
                          preferred_element_type=preferred_element_type, **kw)
    mod = types.ModuleType("jnp_upcast")
    mod.__dict__.update(jnp.__dict__)
    mod.einsum = einsum
    return mod


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_bf16(arch, bf16_compute):
    r, t, params, pnp, batch = reference(arch)
    if r.is_moe:
        bf16_compute.setattr(RL, "jnp", _upcasting_jnp())
    ref_loss, ref_m = jax.jit(functools.partial(
        RM.lm_loss, cfg=r, kv_chunk=KV, loss_chunk=KV))(params, batch=batch)
    lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
    with torch.no_grad():
        loss, m = TM.lm_loss(lm, t, torch_batch(batch), kv_chunk=KV,
                             loss_chunk=KV)
    assert np.isfinite(float(loss))
    assert abs(float(loss) - float(ref_loss)) <= BF16_TOL * abs(
        float(ref_loss))
    assert abs(float(m["aux"]) - float(ref_m["aux"])) <= BF16_TOL * max(
        abs(float(ref_m["aux"])), 1.0)


def test_xent_chunk_keeps_float32_logits(bf16_compute):
    """The xent chunk's logits in bf16 compute are the reference's float32
    einsum (``models/model.py:37``) within 1e-4 of their largest, and its
    nll sum within 1e-4 relative; a product rounded to bf16 misses the
    logits by ~3e-3 of their largest."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((4, 64, 256)).astype(np.float32)
    head = (rng.standard_normal((256, 512)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 512, (4, 64)).astype(np.int32)
    mask = np.ones((4, 64), np.float32)
    ref_logits = jnp.einsum("bcd,dv->bcv", jnp.asarray(h).astype(jnp.bfloat16),
                            jnp.asarray(head).astype(jnp.bfloat16),
                            preferred_element_type=jnp.float32)
    ref_sum, ref_n = jax.jit(RM._xent_chunk)(h, head, labels, mask)
    th, thead = torch.as_tensor(h), torch.as_tensor(head)
    logits = TL.dot("bcd,dv->bcv", TL.cast(th), TL.cast(thead))
    assert logits.dtype == torch.float32
    assert_close(logits, ref_logits, "xent logits")
    rounded = (TL.cast(th) @ TL.cast(thead)).float().numpy()
    scale = float(np.abs(np.asarray(ref_logits)).max())
    assert np.abs(rounded - np.asarray(ref_logits)).max() > 1e-3 * scale
    s, n = TM.xent_chunk(th, thead, torch.as_tensor(labels),
                         torch.as_tensor(mask))
    assert abs(float(s) - float(ref_sum)) <= 1e-4 * abs(float(ref_sum))
    assert float(n) == float(ref_n)


def _port_params(arch, **over):
    t = TC.reduced(TC.get_arch(arch), **over)
    return t, TM.init_params(t, seed=0, device="cpu")


def test_decode_consistent_with_teacher_forcing(f32_compute):
    """``test_models_smoke.py:65`` on the port: prefill 7 tokens, decode
    the 8th, equal to the no-cache forward at position 8 (the reference's
    2e-3)."""
    t, lm = _port_params("phi3-mini-3.8b")
    p = lm.tree()
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, t.vocab, (B, 8)))
    with torch.no_grad():
        h, _, _ = TT.forward(p, t, p["embed"][toks], torch.arange(8),
                             kv_chunk=8)
        h = TL.rms_norm(h, p["final_norm"], t.norm_eps)
        full = torch.einsum("bsd,dv->bsv", h, p["lm_head"])
    cache = TM.init_cache(t, B, 16, device="cpu")
    cache, _ = TM.prefill(lm, t, {"tokens": toks[:, :7]}, cache, kv_chunk=8)
    logits, _ = TM.decode_step(lm, t, toks[:, 7], cache, 7, kv_chunk=8)
    np.testing.assert_allclose(logits.numpy(), full[:, 7].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_swa_ring_cache_matches_reference(f32_compute):
    """``test_models_smoke.py:87``: h2o-danube with a 16-token window and
    a 64-token cache (the ring buffer), prefill 32 then 4 decode steps
    past the window: finite, and equal to the reference's ring within
    1e-4."""
    r = RC.reduced(RC.get_arch("h2o-danube-3-4b"), swa_window=16)
    t = TC.reduced(TC.get_arch("h2o-danube-3-4b"), swa_window=16)
    params = jax.jit(lambda k: RM.init_params(k, r))(jax.random.PRNGKey(0))
    lm = convert.lm_params_from_numpy(t, jax.tree.map(np.asarray, params),
                                      device="cpu")
    cache = TM.init_cache(t, B, 64, device="cpu")
    assert "pos" in cache["attn"] and cache["attn"]["k"].shape[2] == 16
    toks = np.random.default_rng(0).integers(0, r.vocab, (B, 32)).astype(
        np.int32)
    ref_cache, ref_logits = RM.prefill(params, r, {"tokens": toks},
                                       RM.init_cache(r, B, 64), kv_chunk=16)
    cache, logits = TM.prefill(lm, t, {"tokens": torch.as_tensor(toks)},
                               cache, kv_chunk=16)
    assert_close(logits, ref_logits, "ring prefill logits")
    step = jax.jit(functools.partial(RM.decode_step, cfg=r))
    tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for i in range(4):
        ref_logits, ref_cache = step(params, token=tok, cache=ref_cache,
                                     pos=jnp.int32(32 + i))
        logits, cache = TM.decode_step(lm, t, torch.as_tensor(tok), cache,
                                       32 + i)
        assert torch.isfinite(logits).all()
        assert_close(logits, ref_logits, f"ring decode {i}")
        tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    assert np.array_equal(cache["attn"]["pos"].numpy(),
                          np.asarray(ref_cache["attn"]["pos"]))


def test_moe_capacity_drop_rate(f32_compute):
    """``test_models_smoke.py:106``: roughly balanced tokens give an aux
    loss near 1; equal to the reference's ``moe`` within 1e-4."""
    r = RC.reduced(RC.get_arch("moonshot-v1-16b-a3b"))
    t = TC.reduced(TC.get_arch("moonshot-v1-16b-a3b"))
    p = RL.moe_params(jax.random.PRNGKey(0), r)
    x = np.random.default_rng(0).standard_normal((2, 64, r.d_model)).astype(
        np.float32)
    ref_out, ref_aux = RL.moe(p, x, r, group_size=128)
    out, aux = TL.moe({k: torch.as_tensor(np.array(v)) for k, v in
                       p.items()}, torch.as_tensor(x), t, group_size=128)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert float(aux) > 0.5
    assert_close(out, ref_out, "moe out")
    assert abs(float(aux) - float(ref_aux)) <= 1e-4 * float(ref_aux)


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, float("-inf"), 3.0, float("-inf")]])
    vals, idx = TL.top_k(x, 5)
    rv, ri = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ri).tolist() == [[1, 2, 4, 0, 3]]
    assert vals.tolist() == np.asarray(rv).tolist()


def _mixer(arch):
    t, lm = _port_params(arch)
    return t, TT._index(lm.tree()["layers"], 0)["mixer"]


@pytest.fixture
def scan_after():
    yield
    TS.set_mamba2_impl("scan")


def test_mamba2_ssd_equals_scan(f32_compute, scan_after):
    t, p = _mixer("zamba2-2.7b")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 64, t.d_model)).astype(np.float32) * 0.5)
    with torch.no_grad():
        TS.set_mamba2_impl("scan")
        y1, c1 = TS.mamba2(p, x, t, chunk=16)
        TS.set_mamba2_impl("ssd")
        y2, c2 = TS.mamba2(p, x, t, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(c1["ssm"].numpy(), c2["ssm"].numpy(),
                               rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("impl", ["scan", "ssd"])
def test_mamba2_decode_matches_parallel(impl, f32_compute, scan_after):
    t, p = _mixer("zamba2-2.7b")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (1, 9, t.d_model)).astype(np.float32) * 0.5)
    TS.set_mamba2_impl(impl)
    cache = TT._index(TM.init_cache(t, 1, 16, device="cpu")["ssm"], 0)
    with torch.no_grad():
        y_par, _ = TS.mamba2(p, x, t, chunk=4)
        outs = []
        for i in range(9):
            y, cache = TS.mamba2(p, x[:, i:i + 1], t, cache=cache)
            outs.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-4)


def test_mamba1_decode_matches_parallel(f32_compute):
    t, p = _mixer("falcon-mamba-7b")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (1, 8, t.d_model)).astype(np.float32) * 0.5)
    cache = TT._index(TM.init_cache(t, 1, 16, device="cpu")["ssm"], 0)
    with torch.no_grad():
        y_par, _ = TS.mamba1(p, x, t, chunk=4)
        outs = []
        for i in range(8):
            y, cache = TS.mamba1(p, x[:, i:i + 1], t, cache=cache)
            outs.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=5e-3, atol=5e-4)


def test_mamba_chunk_size_invariance(f32_compute):
    t, p = _mixer("falcon-mamba-7b")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 32, t.d_model)).astype(np.float32) * 0.5)
    with torch.no_grad():
        y8, _ = TS.mamba1(p, x, t, chunk=8)
        y32, _ = TS.mamba1(p, x, t, chunk=32)
    np.testing.assert_allclose(y8.numpy(), y32.numpy(), rtol=2e-3, atol=2e-4)


def test_mamba2_ssd_loss_equals_reference(f32_compute, scan_after):
    """zamba2's loss and gradients under the SSD solver on both sides,
    within 1e-4 (the Hillis-Steele scan is covered by the per-arch
    tests)."""
    from repro.models import ssm as RS
    r, t, params, pnp, batch = reference("zamba2-2.7b")
    RS.set_mamba2_impl("ssd")
    TS.set_mamba2_impl("ssd")
    try:
        (ref_loss, _), ref_g = jax.jit(jax.value_and_grad(functools.partial(
            RM.lm_loss, cfg=r, kv_chunk=KV, loss_chunk=KV), has_aux=True))(
            params, batch=batch)
    finally:
        RS.set_mamba2_impl("scan")
    lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
    loss, _ = TM.lm_loss(lm, t, torch_batch(batch), kv_chunk=KV,
                         loss_chunk=KV)
    loss.backward()
    assert_close(loss, ref_loss, "ssd loss")
    grads = {n.replace(".", "/"): q.grad for n, q in lm.named_parameters()}
    for name, g in flat(ref_g).items():
        assert_close(grads[name], g, f"ssd grad {name}")


def test_mamba2_impl_refuses_unknown():
    with pytest.raises(ValueError, match="scan"):
        TS.set_mamba2_impl("fast")


@pytest.mark.parametrize("arch", ["qwen3-8b", "moonshot-v1-16b-a3b"])
def test_lean_internals_and_bf16_combine(arch, bf16_compute):
    """``set_lean_internals(True)`` (bf16 norms, probabilities and MoE
    up-projections) and a bf16 MoE combine, on both sides in bf16
    compute: the loss within 2e-3."""
    r, t, params, pnp, batch = reference(arch)
    if r.is_moe:
        bf16_compute.setattr(RL, "jnp", _upcasting_jnp())
    RL.set_lean_internals(True)
    RL.set_moe_combine_dtype(jnp.bfloat16)
    TL.set_lean_internals(True)
    TL.set_moe_combine_dtype(torch.bfloat16)
    try:
        ref_loss, _ = jax.jit(functools.partial(
            RM.lm_loss, cfg=r, kv_chunk=KV, loss_chunk=KV))(params,
                                                            batch=batch)
        lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
        with torch.no_grad():
            loss, _ = TM.lm_loss(lm, t, torch_batch(batch), kv_chunk=KV,
                                 loss_chunk=KV)
    finally:
        RL.set_lean_internals(False)
        RL.set_moe_combine_dtype(jnp.float32)
        TL.set_lean_internals(False)
        TL.set_moe_combine_dtype(torch.float32)
    assert abs(float(loss) - float(ref_loss)) <= BF16_TOL * abs(
        float(ref_loss))
