"""The port's LM models against the reference, all ten architectures at
reduced size (d 64, 2 layers, vocab 256, S 32, B 2), the reference's
parameters carried across by ``convert.lm_params_from_numpy`` and the
same numpy batch fed to both; the reference side jitted.

float32 compute on both sides: ``lm_loss`` and every gradient, prefill's
last logits and the whole cache, three decode steps' logits, each within
1e-4 of the reference relative to its largest magnitude.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT

ARCHS = sorted(RC.ARCHS)
B, SQ, MAX_SEQ, KV = 2, 32, 64, 16
TOL = 1e-4


@pytest.fixture(autouse=True)
def f32_compute():
    """The reference computes in float32 under the test conftest."""
    TL.set_compute_dtype(torch.float32)
    yield
    TL.set_compute_dtype(torch.bfloat16)


def assert_close(port, ref, what, tol=TOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port.astype(np.float64) - ref).max()) if ref.size \
        else 0.0
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


@functools.lru_cache(maxsize=None)
def reference(arch):
    """(reference cfg, port cfg, reference params, numpy params, batch)."""
    r = RC.reduced(RC.get_arch(arch))
    t = TC.reduced(TC.get_arch(arch))
    params = jax.jit(lambda k: RM.init_params(k, r))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, r.vocab, (B, SQ)).astype(np.int32),
             "labels": rng.integers(0, r.vocab, (B, SQ)).astype(np.int32)}
    if r.family == "encdec":
        batch["enc_in"] = rng.standard_normal(
            (B, r.enc_seq, r.d_model)).astype(np.float32)
    if r.family == "vlm":
        batch["loss_mask"] = (rng.random((B, SQ)) > 0.2).astype(np.float32)
    return r, t, params, jax.tree.map(np.asarray, params), batch


def flat(tree):
    return {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32(arch):
    r, t, params, pnp, batch = reference(arch)
    (ref_loss, ref_m), ref_g = jax.jit(jax.value_and_grad(functools.partial(
        RM.lm_loss, cfg=r, kv_chunk=KV, loss_chunk=KV), has_aux=True))(
        params, batch=batch)
    lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
    loss, m = TM.lm_loss(lm, t, torch_batch(batch), kv_chunk=KV,
                         loss_chunk=KV)
    loss.backward()
    assert_close(loss, ref_loss, "loss")
    assert_close(m["xent"], ref_m["xent"], "xent")
    assert_close(m["aux"], ref_m["aux"], "aux")
    if t.is_moe:
        assert float(m["aux"].detach()) > 0
    grads = {n.replace(".", "/"): p.grad for n, p in lm.named_parameters()}
    ref_grads = flat(ref_g)
    assert set(grads) == set(ref_grads)
    for name, g in ref_grads.items():
        assert_close(grads[name], g, f"grad {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_f32(arch):
    r, t, params, pnp, batch = reference(arch)
    batch = {k: v for k, v in batch.items() if k != "labels"}
    ref_cache, ref_logits = jax.jit(functools.partial(
        RM.prefill, cfg=r, kv_chunk=KV))(params, batch=batch,
                                         cache=RM.init_cache(r, B, MAX_SEQ))
    lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
    cache = TM.init_cache(t, B, MAX_SEQ, device="cpu")
    cache, logits = TM.prefill(lm, t, torch_batch(batch), cache,
                               kv_chunk=KV)
    assert_close(logits, ref_logits, "prefill logits")
    ours = {"/".join(p): v for p, v in TT.tree_leaves(cache)}
    ref = flat(ref_cache)
    assert set(ours) == set(ref)
    for name, v in ref.items():
        assert_close(ours[name], v, f"prefill cache {name}")

    step = jax.jit(functools.partial(RM.decode_step, cfg=r, kv_chunk=KV))
    tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for i in range(3):
        ref_logits, ref_cache = step(params, token=tok, cache=ref_cache,
                                     pos=jnp.int32(SQ + i))
        logits, cache = TM.decode_step(lm, t, torch.as_tensor(tok), cache,
                                       SQ + i, kv_chunk=KV)
        assert_close(logits, ref_logits, f"decode {i} logits")
        tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    ours = {"/".join(p): v for p, v in TT.tree_leaves(cache)}
    for name, v in flat(ref_cache).items():
        assert_close(ours[name], v, f"decode cache {name}")


def test_lm_module_names_are_the_reference_paths():
    r, t, _, pnp, _ = reference("zamba2-2.7b")
    lm = convert.lm_params_from_numpy(t, pnp, device="cpu")
    assert {n.replace(".", "/") for n, _ in lm.named_parameters()} == \
        set(flat(pnp))
    back = convert.lm_params_to_numpy(lm)
    for name, v in flat(pnp).items():
        assert np.array_equal(flat(back)[name], v)
    shapes = {"/".join(p): tuple(v.shape)
              for p, v in TT.tree_leaves(TT.abstract_params(t))}
    assert shapes == {k: v.shape for k, v in flat(pnp).items()}
    assert TT.n_params(lm) == sum(v.size for v in flat(pnp).values())
