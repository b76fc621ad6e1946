"""The train step and the serve steps on one device (the reference's
``train/steps.py`` without its mesh).

``build_train_step`` returns

    step(params, opt_state, batch, monitor) -> (params, opt_state, metrics, monitor)

with optional microbatch accumulation, the NaN-step skip decided on the
device (``torch.where``, no host read) and the step's loss and gradient
norm folded into the QO telemetry (:func:`repro_torch.train.monitor.
observe`: the ``qo_update`` kernel on the card).  Parameters and AdamW
state are updated in place (the reference donates them).

``build_serve_steps`` returns (prefill, decode, init_cache) for serving
shapes.

The reference's mesh, ``seq_parallel``, ``sharding_style`` and the
un-donated step are its multi-device layer (ROADMAP A14b): a value other
than their defaults raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as dv
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON

__all__ = ["input_specs", "abstract_params", "abstract_state",
           "build_train_step", "build_serve_steps"]


def _refuse_sharding(mesh=None, seq_parallel=False,
                     sharding_style="contraction", donate=True):
    for name, value, default in (("mesh", mesh, None),
                                 ("seq_parallel", seq_parallel, False),
                                 ("sharding_style", sharding_style,
                                  "contraction"),
                                 ("donate", donate, True)):
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r}: the LM sharding layer is not ported yet "
                f"(ROADMAP A14b); the port runs one device, updated in place")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of a shape config.

    train: {tokens, labels} (+ loss_mask for vlm); prefill: {tokens};
    encdec adds enc_in; decode: {token}.
    """
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            out["labels"] = _meta((B, S), torch.int32)
            if cfg.family == "vlm":
                out["loss_mask"] = _meta((B, S), torch.float32)
        if cfg.family == "encdec":
            out["enc_in"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                  compute_dtype())
    else:
        out["token"] = _meta((B,), torch.int32)
    return out


abstract_params = T.abstract_params


def abstract_state(cfg, opt_cfg=None):
    """(params, AdamW state) on the ``meta`` device: the restore templates
    of a trainer checkpoint."""
    pshapes = abstract_params(cfg)
    like = lambda t: _meta(t.shape, t.dtype)
    return pshapes, {"m": T.tree_map(like, pshapes),
                     "v": T.tree_map(like, pshapes),
                     "step": _meta((), torch.int32)}


def build_train_step(cfg, shape, opt_cfg=None, *, microbatch: int = 0,
                     remat=True, kv_chunk=512, with_monitor=True, device=None,
                     mesh=None, donate=True, seq_parallel=False,
                     sharding_style="contraction"):
    """The train step on ``device`` (default ``cuda``).  Without
    ``with_monitor`` (or with ``monitor=None``) the step observes
    nothing."""
    _refuse_sharding(mesh, seq_parallel, sharding_style, donate)
    dev = dv.resolve(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss_fn(params, batch):
        return M.lm_loss(params, cfg, batch, remat=remat, kv_chunk=kv_chunk)

    def grads_of(params, batch):
        paths, leaves = zip(*T.tree_leaves(params))
        with torch.enable_grad():
            loss, metrics = loss_fn(params, batch)
            g = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            T.tree_unflatten(params, dict(zip(paths, g)))

    def step(params, opt_state, batch, monitor=None):
        tree = T.tree_of(params)
        dv.check_on(tree["embed"], dev, "params")
        if microbatch and microbatch > 1:
            nm = microbatch
            B = batch["tokens"].shape[0]
            if B % nm:
                raise ValueError(f"batch {B} does not split into {nm} "
                                 f"microbatches")
            grads, loss = None, torch.zeros((), device=dev)
            for i in range(nm):
                mb = {k: v[i * (B // nm):(i + 1) * (B // nm)]
                      for k, v in batch.items()}
                l, _, g = grads_of(tree, mb)
                grads = g if grads is None else T.tree_map2(
                    torch.add, grads, g)
                loss = loss + l
            grads = T.tree_map(lambda g: g / nm, grads)
            loss = loss / nm
            metrics = {"xent": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=dev)}
        else:
            loss, metrics, grads = grads_of(tree, batch)

        loss_ok = torch.isfinite(loss)
        _, _, opt_metrics = adamw.apply(
            opt_cfg, tree, opt_state, grads, inplace=True,
            keep_if=lambda gnorm: loss_ok & torch.isfinite(gnorm))
        finite = loss_ok & torch.isfinite(opt_metrics["grad_norm"])
        metrics = dict(metrics, **opt_metrics, loss=loss,
                       skipped=(~finite).to(torch.float32))
        if with_monitor and monitor is not None:
            monitor = MON.observe(monitor, loss=loss,
                                  grad_norm=opt_metrics["grad_norm"])
        return params, opt_state, metrics, monitor

    return step


def build_serve_steps(cfg, shape, *, kv_chunk=512, device=None, mesh=None):
    """(prefill, decode, init_cache) for ``shape`` (global_batch B,
    seq_len the cache length) on ``device`` (default ``cuda``):

    * ``prefill(params, batch, cache) -> (cache, last_logits)``;
    * ``decode(params, token, cache, pos) -> (logits, cache)``;
    * ``init_cache() ->`` a zeroed cache of B x seq_len.

    The cache is written in place."""
    _refuse_sharding(mesh)
    dev = dv.resolve(device)
    B, S = shape.global_batch, shape.seq_len

    def prefill(params, batch, cache):
        dv.check_on(T.tree_of(params)["embed"], dev, "params")
        return M.prefill(params, cfg, batch, cache, kv_chunk=kv_chunk)

    def decode(params, token, cache, pos):
        return M.decode_step(params, cfg, token, cache, pos,
                             kv_chunk=kv_chunk)

    return prefill, decode, lambda: M.init_cache(cfg, B, S, device=dev)
