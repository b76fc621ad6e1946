"""AdamW + cosine schedule + global-norm clipping (the reference's
``optim/adamw.py``) as functions on the nested parameter dict.

The update is the reference's, in its order: clip the gradients by their
global norm, then the moments, then ``p - lr * (u + wd * p)`` with the
bias-corrected ``u``.  (``torch.optim.AdamW`` decays before the moment
update and is a different function.)  ``apply`` is pure;
``apply(..., inplace=True)`` writes the new values into the given
parameters and state leaf by leaf, so no second copy of the model is
alive at once (the counterpart of the reference's donated buffers), and
``keep_if`` gates those writes on the device (the NaN-step skip).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.transformer import (tree_leaves, tree_map, tree_of,
                                            tree_unflatten)

__all__ = ["AdamWConfig", "init_state", "schedule", "global_norm",
           "clip_by_global_norm", "apply"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _values(tree):
    return [t for _, t in tree_leaves(tree)]


def init_state(params) -> Dict[str, Any]:
    """Zero moments beside each parameter, step 0 (int32), on the
    parameters' device."""
    params = tree_of(params)
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p.detach()), params)
    dev = _values(params)[0].device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step):
    """Linear warmup, then cosine to ``min_lr_frac`` of ``lr``; float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    return torch.sqrt(torch.stack([torch.sum(t.float() ** 2)
                                   for t in _values(tree)]).sum())


def _clip_scale(norm, max_norm):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def apply(cfg: AdamWConfig, params, state, grads, *, inplace: bool = False,
          keep_if: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """One AdamW step.  Returns (new_params, new_state, {grad_norm, lr}).

    ``inplace``: write the results into ``params`` and ``state`` (leaf by
    leaf, without autograd) and return them.  ``keep_if(grad_norm)`` -> a
    0-d bool tensor: where false, every parameter, moment and the step
    keep their old values (a ``torch.where``, no host read)."""
    params = tree_of(params)
    # clip leaf by leaf below (clip_by_global_norm's scale): no clipped
    # copy of every gradient at once
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    t = step.to(torch.float32)
    mc = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=t.device), t)
    vc = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=t.device), t)
    keep = None if keep_if is None else keep_if(gnorm)

    def gate(new, old):
        return new if keep is None else torch.where(keep, new, old)

    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for (path, p), (_, g), (_, m0), (_, v0) in zip(
                tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                tree_leaves(state["v"])):
            g = g * scale
            m = b1 * m0 + (1 - b1) * g
            v = b2 * v0 + (1 - b2) * g * g
            u = (m / mc) / (torch.sqrt(v / vc) + cfg.eps)
            pn = p - lr * (u + cfg.weight_decay * p)
            if inplace:
                p.copy_(gate(pn, p))
                m0.copy_(gate(m, m0))
                v0.copy_(gate(v, v0))
            else:
                new_p[path], new_m[path] = gate(pn, p), gate(m, m0)
                new_v[path] = gate(v, v0)
        new_step = gate(step, state["step"])
        if inplace:
            state["step"].copy_(new_step)
            return params, state, {"grad_norm": gnorm, "lr": lr}
    new_state = {"m": tree_unflatten(params, new_m),
                 "v": tree_unflatten(params, new_v), "step": new_step}
    return tree_unflatten(params, new_p), new_state, \
        {"grad_norm": gnorm, "lr": lr}
