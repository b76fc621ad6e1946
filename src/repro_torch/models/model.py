"""Public model API (the reference's ``models/model.py``): init, loss,
prefill and decode for every family.

``lm_loss`` computes a chunked cross-entropy: the (B, S, V) logits are
never materialised whole, one (B, C, V) chunk at a time.  ``prefill`` and
``decode_step`` run without autograd and write the caches of
:func:`init_cache` in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype, mm, rms_norm

__all__ = ["init_params", "init_cache", "lm_loss", "prefill", "decode_step",
           "xent_chunk"]

init_params = T.init_params
init_cache = T.init_cache


def _lookup(table, ids):
    """Rows ``ids`` of ``table`` (V, d).

    Under a mesh the lookup is the vocab-parallel one, written out (the
    DTensor embedding rule mis-sizes its mask once the batch and the
    table's d axis are sharded over the same mesh axis): the table is
    gathered along d (an FSDP all-gather), each rank looks up the ids
    that fall in its vocab shard, zeros the others, and the result is
    partial over the vocab-sharded mesh axes (summed where the residual
    stream is pinned)."""
    if not L.is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    table = table.redistribute(mesh, [
        p if type(p) is Shard and p.dim == 0 else Replicate()
        for p in table.placements])
    vocab = [p.is_shard(0) for p in table.placements]
    if not L.is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim)
    ids = ids.redistribute(mesh, [Replicate() if v else p
                                  for v, p in zip(vocab, ids.placements)])
    batch = [p.is_shard(0) for p in ids.placements]
    local = table.to_local(grad_placements=[
        p if v else (Partial() if b else Replicate())
        for v, b, p in zip(vocab, batch, table.placements)])
    _, off = compute_local_shape_and_global_offset(table.shape, mesh,
                                                   table.placements)
    idx = ids.to_local()
    mine = (idx >= off[0]) & (idx < off[0] + local.shape[0])
    out = F.embedding(torch.where(mine, idx - off[0], 0), local) \
        * mine[..., None].to(local.dtype)
    return DTensor.from_local(out, mesh, [
        Partial() if v else p for v, p in zip(vocab, ids.placements)])


def _pick(logits, labels):
    """``logits[..., labels]`` along the last (vocab) axis.  Under a mesh
    written out as :func:`_lookup` is (DTensor's gather rule has the same
    mask fault): each rank picks the labels in its vocab shard, the
    result partial over the vocab-sharded mesh axes."""
    if not L.is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, last = logits.device_mesh, logits.ndim - 1
    # plain shards only (a strided vocab shard and partial sums are
    # gathered)
    logits = logits.redistribute(mesh, [
        p if type(p) is Shard else Replicate() for p in logits.placements])
    vocab = [p.is_shard(last) for p in logits.placements]
    if not L.is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    labels = labels.redistribute(mesh, [Replicate() if v else p for v, p in
                                        zip(vocab, logits.placements)])
    _, off = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                   logits.placements)
    local, idx = logits.to_local(), labels.to_local().long()
    mine = (idx >= off[last]) & (idx < off[last] + local.shape[-1])
    got = torch.gather(local, -1, torch.where(mine, idx - off[last], 0)
                       [..., None])[..., 0] * mine.to(local.dtype)
    return DTensor.from_local(got, mesh, [
        Partial() if v else p for v, p in zip(vocab, logits.placements)])


def _embed(params, cfg, batch):
    """Token ids -> (B, S, d); modality-stub archs feed embeddings."""
    if cfg.frontend_stub and "embeds" in batch:
        return batch["embeds"].to(compute_dtype())
    return _lookup(params["embed"], batch["tokens"]).to(compute_dtype())


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
    tgt = _pick(logits, labels)
    nll = (lse - tgt) * mask
    return nll.sum(), mask.sum()


def lm_loss(params, cfg, batch, *, remat=True, kv_chunk=512, loss_chunk=512,
            aux_weight=0.01, act_spec=None):
    """batch: tokens (B,S) int, labels (B,S) int, [loss_mask (B,S)],
    [embeds (B,S,d) for frontend stubs], [enc_in (B,Senc,d) for encdec].
    ``act_spec``: the residual stream's spec under a mesh.
    Returns (loss + aux_weight * aux, {xent, aux})."""
    params = T.tree_of(params)
    x = _embed(params, cfg, batch)
    B, Seq = x.shape[:2]
    positions = torch.arange(Seq, device=x.device)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = T.encode(params, cfg, batch["enc_in"].to(compute_dtype()),
                           remat=remat, kv_chunk=kv_chunk, act_spec=act_spec)

    hidden, _, aux = T.forward(params, cfg, x, positions, enc_out=enc_out,
                               remat=remat, kv_chunk=kv_chunk,
                               act_spec=act_spec)
    hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)

    head = _lm_head(params, cfg)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)

    C = min(loss_chunk, Seq)
    if Seq % C:
        raise ValueError(f"lm_loss: sequence {Seq} is not a multiple of the "
                         f"loss chunk {C}")
    tot = cnt = 0.0
    for c0 in range(0, Seq, C):
        s, n = xent_chunk(hidden[:, c0:c0 + C], head, labels[:, c0:c0 + C],
                          mask[:, c0:c0 + C])
        tot, cnt = tot + s, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


@torch.no_grad()
def prefill(params, cfg, batch, cache, *, kv_chunk=512, act_spec=None):
    """Fill the decode cache (of :func:`init_cache`, written in place) from
    a prompt with the train-style forward; returns (cache,
    last_logits (B, V) float32)."""
    params = T.tree_of(params)
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)

    enc_out = None
    if cfg.family == "encdec":
        enc_out = T.encode(params, cfg, batch["enc_in"].to(compute_dtype()),
                           kv_chunk=kv_chunk, act_spec=act_spec)

    hidden, cache, _ = T.forward(params, cfg, x, positions, caches=cache,
                                 cache_pos=0, enc_out=enc_out,
                                 kv_chunk=kv_chunk, act_spec=act_spec)
    hidden = rms_norm(hidden[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = mm("bcd,dv->bcv", hidden, _lm_head(params, cfg))
    return cache, logits[:, 0]


@torch.no_grad()
def decode_step(params, cfg, token, cache, pos, *, kv_chunk=512,
                act_spec=None):
    """One decode step: token (B,) ids (or (B, d) embeds for stubs), pos
    an int.  Writes the cache in place; returns (logits (B, V), cache)."""
    params = T.tree_of(params)
    if cfg.frontend_stub and token.ndim == 2:
        x = token[:, None].to(compute_dtype())
    else:
        x = _lookup(params["embed"], token)[:, None].to(compute_dtype())
    pos = int(pos)
    positions = pos + torch.arange(1, device=x.device)
    hidden, cache, _ = T.forward(params, cfg, x, positions, caches=cache,
                                 cache_pos=pos, kv_chunk=kv_chunk,
                                 act_spec=act_spec)
    hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
    logits = mm("bcd,dv->bcv", hidden, _lm_head(params, cfg))
    return logits[:, 0], cache
