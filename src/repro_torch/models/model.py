"""Public model API (the reference's ``models/model.py``): init, loss,
prefill and decode for every family.

``lm_loss`` computes a chunked cross-entropy: the (B, S, V) logits are
never materialised whole, one (B, C, V) chunk at a time.  ``prefill`` and
``decode_step`` run without autograd and write the caches of
:func:`init_cache` in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype, mm, rms_norm

__all__ = ["init_params", "init_cache", "lm_loss", "prefill", "decode_step",
           "xent_chunk"]

init_params = T.init_params
init_cache = T.init_cache


def _embed(params, cfg, batch):
    """Token ids -> (B, S, d); modality-stub archs feed embeddings."""
    if cfg.frontend_stub and "embeds" in batch:
        return batch["embeds"].to(compute_dtype())
    return params["embed"][batch["tokens"]].to(compute_dtype())


def _lm_head(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def xent_chunk(hidden, head, labels, mask):
    """hidden (B, C, d), head (d, V), labels (B, C) -> (sum of the masked
    nll, sum of the mask).  The logits stay float32 (the reference's
    ``preferred_element_type``): rounding them to bf16 would move them by
    ~3e-3 of their largest."""
    logits = mm("bcd,dv->bcv", hidden, head)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - tgt) * mask
    return nll.sum(), mask.sum()


def lm_loss(params, cfg, batch, *, remat=True, kv_chunk=512, loss_chunk=512,
            aux_weight=0.01):
    """batch: tokens (B,S) int, labels (B,S) int, [loss_mask (B,S)],
    [embeds (B,S,d) for frontend stubs], [enc_in (B,Senc,d) for encdec].
    Returns (loss + aux_weight * aux, {xent, aux})."""
    params = T.tree_of(params)
    x = _embed(params, cfg, batch)
    B, Seq = x.shape[:2]
    positions = torch.arange(Seq, device=x.device)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = T.encode(params, cfg, batch["enc_in"].to(compute_dtype()),
                           remat=remat, kv_chunk=kv_chunk)

    hidden, _, aux = T.forward(params, cfg, x, positions, enc_out=enc_out,
                               remat=remat, kv_chunk=kv_chunk)
    hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)

    head = _lm_head(params, cfg)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)

    C = min(loss_chunk, Seq)
    if Seq % C:
        raise ValueError(f"lm_loss: sequence {Seq} is not a multiple of the "
                         f"loss chunk {C}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, Seq, C):
        s, n = xent_chunk(hidden[:, c0:c0 + C], head, labels[:, c0:c0 + C],
                          mask[:, c0:c0 + C])
        tot, cnt = tot + s, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


@torch.no_grad()
def prefill(params, cfg, batch, cache, *, kv_chunk=512):
    """Fill the decode cache (of :func:`init_cache`, written in place) from
    a prompt with the train-style forward; returns (cache,
    last_logits (B, V) float32)."""
    params = T.tree_of(params)
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = T.encode(params, cfg, batch["enc_in"].to(compute_dtype()),
                           kv_chunk=kv_chunk)

    hidden, cache, _ = T.forward(params, cfg, x, positions, caches=cache,
                                 cache_pos=0, enc_out=enc_out,
                                 kv_chunk=kv_chunk)
    hidden = rms_norm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = mm("bcd,dv->bcv", hidden, _lm_head(params, cfg))
    return cache, logits[:, 0]


@torch.no_grad()
def decode_step(params, cfg, token, cache, pos, *, kv_chunk=512):
    """One decode step: token (B,) ids (or (B, d) embeds for stubs), pos
    an int.  Writes the cache in place; returns (logits (B, V), cache)."""
    params = T.tree_of(params)
    if cfg.frontend_stub and token.ndim == 2:
        x = token[:, None].to(compute_dtype())
    else:
        x = params["embed"][token][:, None].to(compute_dtype())
    pos = int(pos)
    positions = pos + torch.arange(1, device=x.device)
    hidden, cache, _ = T.forward(params, cfg, x, positions, caches=cache,
                                 cache_pos=pos, kv_chunk=kv_chunk)
    hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    logits = mm("bcd,dv->bcv", hidden, _lm_head(params, cfg))
    return logits[:, 0], cache
