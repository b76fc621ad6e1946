"""The train step and the serve steps (the reference's
``train/steps.py``), on one device or over a ``DeviceMesh``.

``build_train_step`` returns

    step(params, opt_state, batch, monitor) -> (params, opt_state, metrics, monitor)

with optional microbatch accumulation, the NaN-step skip decided on the
device (``torch.where``, no host read) and the step's loss and gradient
norm folded into the QO telemetry whenever a monitor is passed
(:func:`repro_torch.train.monitor.observe`: the ``qo_update`` kernel on
the card).  Parameters and AdamW state are updated in place (the
reference donates them); ``donate=False`` computes out of place and
leaves every input as it was.

Under ``mesh`` the parameters, AdamW state and batch are DTensors placed
by :mod:`repro_torch.train.sharding` (the step places any input that is
not yet, as the reference's ``in_shardings`` do), the model runs on them
through DTensor's sharding rules with the residual stream pinned to
``(fsdp, seq, None)`` at every layer boundary (``seq`` the model axis
under ``seq_parallel``), and the clipping norm is the norm over all
shards.  The monitor's tables are replicated (``monitor_specs``): every
rank holds them whole as plain tensors, and ``observe`` takes the
replicated loss and gradient norm as plain tensors, so the kernel never
sees a DTensor.  Metrics come back as plain (replicated) tensors.

``build_serve_steps`` returns (prefill, decode, init_cache) for serving
shapes, the cache placed by ``cache_specs`` under a mesh.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from repro_torch import device as dv
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import sharding as SH

__all__ = ["input_specs", "abstract_params", "abstract_state",
           "build_train_step", "build_serve_steps"]


def _mixing(mesh):
    """Under a mesh, the plain tensors the model makes (positions, masks,
    scalars) meet DTensors as replicated values: they are alike on every
    rank."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


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
    """The train step on ``device`` (default ``cuda``), over ``mesh`` (a
    ``DeviceMesh`` of that device type) when given.  A monitor passed to
    the step is observed whatever ``with_monitor`` says (as in the
    reference, where it only sets the monitor's shardings); ``monitor=
    None`` observes nothing.  ``seq_parallel`` and ``sharding_style``
    matter under a mesh only."""
    dev = dv.resolve(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    act_spec = None
    if mesh is not None:
        SH.check_mesh(mesh, dev)
        pspecs = SH.param_specs(cfg, abstract_params(cfg), mesh,
                                style=sharding_style)
        ospecs = SH.opt_specs(pspecs)
        bfield = SH.batch_specs(cfg, shape.kind, shape.global_batch, mesh)
        fsdp, tp = SH.mesh_axes(mesh)
        seq_ax = tp if (seq_parallel and shape.seq_len
                        % SH.mesh_sizes(mesh)[tp] == 0) else None
        act_spec = SH.Spec(fsdp, seq_ax, None)  # (batch, seq, d) pin

    def place_batch(batch):
        if mesh is None:
            return batch
        return {k: SH.distribute(v, bfield(k), mesh)
                for k, v in batch.items()}

    def grads_of(params, batch):
        paths, leaves = zip(*T.tree_leaves(params))
        with torch.enable_grad():
            loss, metrics = M.lm_loss(params, cfg, place_batch(batch),
                                      remat=remat, kv_chunk=kv_chunk,
                                      act_spec=act_spec)
            g = torch.autograd.grad(loss, leaves)
        if mesh is not None:
            # each gradient placed as its parameter (DTensor's backward
            # rules may leave one partial or otherwise placed)
            g = [gi.redistribute(p.device_mesh, p.placements)
                 for gi, p in zip(g, leaves)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            T.tree_unflatten(params, dict(zip(paths, g)))

    def step(params, opt_state, batch, monitor=None):
        tree = T.tree_of(params)
        dv.check_on(SH.local_shard(tree["embed"]), dev, "params")
        if mesh is not None:
            placed = SH.distribute(tree, pspecs, mesh)
            if any(a is not b for (_, a), (_, b) in
                   zip(T.tree_leaves(placed), T.tree_leaves(tree))):
                tree = placed
                params = T.LM(cfg, tree)
                tree = params.tree()
            opt_state = SH.distribute(opt_state, ospecs, mesh)
        with _mixing(mesh):
            if microbatch and microbatch > 1:
                nm = microbatch
                B = batch["tokens"].shape[0]
                if B % nm:
                    raise ValueError(f"batch {B} does not split into {nm} "
                                     f"microbatches")
                grads, loss = None, 0.0
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
            new_tree, opt_state, opt_metrics = adamw.apply(
                opt_cfg, tree, opt_state, grads, inplace=donate,
                keep_if=lambda gnorm: loss_ok & torch.isfinite(gnorm))
            finite = loss_ok & torch.isfinite(opt_metrics["grad_norm"])
            metrics = dict(metrics, **opt_metrics, loss=loss,
                           skipped=(~finite).to(torch.float32))
        metrics = {k: SH.local(v) for k, v in metrics.items()}
        if not donate:
            params = T.LM(cfg, new_tree) if isinstance(params, T.LM) \
                else new_tree
        if monitor is not None:
            monitor = MON.observe(monitor, loss=metrics["loss"],
                                  grad_norm=metrics["grad_norm"])
        return params, opt_state, metrics, monitor

    return step


def build_serve_steps(cfg, shape, *, kv_chunk=512, device=None, mesh=None):
    """(prefill, decode, init_cache) for ``shape`` (global_batch B,
    seq_len the cache length) on ``device`` (default ``cuda``), over
    ``mesh`` when given:

    * ``prefill(params, batch, cache) -> (cache, last_logits)``;
    * ``decode(params, token, cache, pos) -> (logits, cache)``;
    * ``init_cache() ->`` a zeroed cache of B x seq_len.

    The cache is written in place.  Under a mesh the parameters are
    placed by ``param_specs`` ("contraction"), the prompt's batch axis
    and the residual stream's over the fsdp axes when B divides them,
    the cache by ``cache_specs``; the logits come back whole as plain
    tensors."""
    dev = dv.resolve(device)
    B, S = shape.global_batch, shape.seq_len
    act_spec = None
    if mesh is not None:
        SH.check_mesh(mesh, dev)
        pspecs = SH.param_specs(cfg, abstract_params(cfg), mesh)
        bfield = SH.batch_specs(cfg, "prefill", B, mesh)
        fsdp, _ = SH.mesh_axes(mesh)
        act_spec = SH.Spec(fsdp if B % SH.fsdp_size(mesh) == 0 else None,
                           None, None)

    def place(params):
        tree = T.tree_of(params)
        dv.check_on(SH.local_shard(tree["embed"]), dev, "params")
        return tree if mesh is None else SH.distribute(tree, pspecs, mesh)

    def prefill(params, batch, cache):
        if mesh is not None:
            batch = {k: SH.distribute(v, bfield(k), mesh)
                     for k, v in batch.items()}
        with _mixing(mesh):
            cache, logits = M.prefill(place(params), cfg, batch, cache,
                                      kv_chunk=kv_chunk, act_spec=act_spec)
        return cache, SH.local(logits)

    def decode(params, token, cache, pos):
        # the token's placement is left to DTensor (it follows the
        # cache's batch axis), as the reference leaves it to the
        # partitioner
        with _mixing(mesh):
            logits, cache = M.decode_step(place(params), cfg, token, cache,
                                          pos, kv_chunk=kv_chunk,
                                          act_spec=act_spec)
        return SH.local(logits), cache

    return prefill, decode, \
        lambda: M.init_cache(cfg, B, S, device=dev, mesh=mesh)
