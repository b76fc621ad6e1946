"""Model family assembly (the reference's ``models/transformer.py``):
decoder-only, MoE, SSM, hybrid and encoder-decoder.

Parameters keep the reference's **stacked** layout: each block kind holds
its leaves as (L, ...) tensors under the reference's names
(``layers.attn.wq`` of shape (L, d, H, hd), ``shared_attn``,
``enc_layers`` ...), in an :class:`LM` module whose :meth:`LM.tree` is the
reference's parameter dict.  The layer stack is a Python loop over views
of layer i (the reference's ``lax.scan``); ``remat`` wraps one layer in
``torch.utils.checkpoint``.  Decode caches are stacked the same way,
preallocated by :func:`init_cache` and written in place (the counterpart
of the reference's donated caches).

Families (cfg.family):
  dense | moe | vlm : decoder-only LM (vlm = early-fusion token stream)
  ssm               : mamba1 stack (attention-free)
  hybrid            : mamba2 stack + one weight-shared attention block
                      applied every cfg.hybrid_period layers (zamba2)
  encdec            : whisper-style encoder + causal decoder w/ cross-attn

``init_params`` draws from a ``torch.Generator``: it cannot reproduce the
reference's threefry draws (ROADMAP C3), so parity goes through
:func:`repro_torch.convert.lm_params_from_numpy`.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as dv
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.layers import compute_dtype, dot, mm, rms_norm

__all__ = ["LM", "param_shapes", "init_params", "abstract_params",
           "init_cache", "forward", "encode", "tree_of", "tree_map",
           "tree_map2", "tree_unflatten", "tree_leaves", "n_params"]


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_map2(fn, a, b):
    """``fn(leaf_a, leaf_b)`` over two nested dicts of one structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def tree_unflatten(like, flat, prefix=()):
    """The structure of ``like`` with each leaf taken from ``flat``, a
    dict keyed by leaf paths (tuples of keys)."""
    return {k: (tree_unflatten(v, flat, prefix + (k,)) if isinstance(v, dict)
                else flat[prefix + (k,)]) for k, v in like.items()}


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` for every leaf, keys in sorted order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


class _Tree(nn.Module):
    """A nested dict of tensors as modules (the dicts) and
    ``nn.Parameter`` leaves, under the dict's keys."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        """The nested dict of the parameters (the tensors themselves)."""
        out = {}
        for k in self._keys:
            v = getattr(self, k)
            out[k] = v.tree() if isinstance(v, _Tree) else v
        return out


class LM(_Tree):
    """One model's parameters under the reference's names;
    ``named_parameters()`` gives ``layers.attn.wq`` ..., ``tree()`` the
    nested dict the functions of this package take."""

    def __init__(self, cfg, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg


def tree_of(params) -> Dict[str, Any]:
    """The nested parameter dict of an :class:`LM` (a dict passes)."""
    return params.tree() if isinstance(params, _Tree) else params


# --------------------------------------------------------------------------
# parameter shapes and init
# --------------------------------------------------------------------------

def _normal(shape, scale):
    return (tuple(shape), "normal", float(scale))


def _const(shape, value):
    return (tuple(shape), "const", float(value))


def _attention_shapes(cfg, n):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": _normal(n + (d, H, hd), d ** -0.5),
         "wk": _normal(n + (d, Hkv, hd), d ** -0.5),
         "wv": _normal(n + (d, Hkv, hd), d ** -0.5),
         "wo": _normal(n + (H, hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        p["q_norm"] = _const(n + (hd,), 1.0)
        p["k_norm"] = _const(n + (hd,), 1.0)
    return p


def _swiglu_shapes(cfg, n):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": _normal(n + (d, f), d ** -0.5),
            "w_up": _normal(n + (d, f), d ** -0.5),
            "w_down": _normal(n + (f, d), f ** -0.5)}


def _moe_shapes(cfg, n):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"router": _normal(n + (d, E), d ** -0.5),
            "w_gate": _normal(n + (E, d, f), d ** -0.5),
            "w_up": _normal(n + (E, d, f), d ** -0.5),
            "w_down": _normal(n + (E, f, d), f ** -0.5)}


def _dense_block_shapes(cfg, n=()):
    p = {"ln1": _const(n + (cfg.d_model,), 1.0),
         "ln2": _const(n + (cfg.d_model,), 1.0),
         "attn": _attention_shapes(cfg, n)}
    if cfg.is_moe:
        p["moe"] = _moe_shapes(cfg, n)
    else:
        p["mlp"] = _swiglu_shapes(cfg, n)
    return p


def _encdec_dec_block_shapes(cfg, n):
    return {"ln1": _const(n + (cfg.d_model,), 1.0),
            "ln_x": _const(n + (cfg.d_model,), 1.0),
            "ln2": _const(n + (cfg.d_model,), 1.0),
            "attn": _attention_shapes(cfg, n),
            "xattn": _attention_shapes(cfg, n),
            "mlp": _swiglu_shapes(cfg, n)}


def _mamba1_shapes(cfg, n):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    r = max(1, d // 16)
    return {"in_proj": _normal(n + (d, 2 * di), d ** -0.5),
            "conv_w": _normal(n + (S.CONV_K, di), 0.5),
            "x_proj": _normal(n + (di, r + 2 * N), di ** -0.5),
            "dt_proj": _normal(n + (r, di), r ** -0.5),
            "dt_bias": _const(n + (di,), 0.0),
            # log(1..N) along the state axis
            "A_log": (n + (di, N), "a_log", 0.0),
            "D": _const(n + (di,), 1.0),
            "out_proj": _normal(n + (di, d), di ** -0.5)}


def _mamba2_shapes(cfg, n):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = di // cfg.ssm_head_dim
    s = d ** -0.5
    return {"in_z": _normal(n + (d, di), s), "in_x": _normal(n + (d, di), s),
            "in_B": _normal(n + (d, N), s), "in_C": _normal(n + (d, N), s),
            "in_dt": _normal(n + (d, nh), s),
            "conv_x": _normal(n + (S.CONV_K, di), 0.5),
            "conv_B": _const(n + (S.CONV_K, N), 0.25),
            "conv_C": _const(n + (S.CONV_K, N), 0.25),
            "dt_bias": _const(n + (nh,), 0.0),
            "A_log": _const(n + (nh,), 0.0),
            "D": _const(n + (nh,), 1.0),
            "norm_scale": _const(n + (di,), 1.0),
            "out_proj": _normal(n + (di, d), di ** -0.5)}


def _ssm_block_shapes(cfg, n):
    mixer = _mamba1_shapes if cfg.ssm_version == 1 else _mamba2_shapes
    return {"ln": _const(n + (cfg.d_model,), 1.0), "mixer": mixer(cfg, n)}


def param_shapes(cfg) -> Dict[str, Any]:
    """The reference's parameter tree with ``(shape, init, scale)``
    leaves (all float32)."""
    d, V, Ln = cfg.d_model, cfg.vocab, (cfg.n_layers,)
    p: Dict[str, Any] = {"embed": _normal((V, d), d ** -0.5),
                         "final_norm": _const((d,), 1.0)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal((d, V), d ** -0.5)
    if cfg.family in ("dense", "moe", "vlm"):
        p["layers"] = _dense_block_shapes(cfg, Ln)
    elif cfg.family == "ssm":
        p["layers"] = _ssm_block_shapes(cfg, Ln)
    elif cfg.family == "hybrid":
        p["layers"] = _ssm_block_shapes(cfg, Ln)
        p["shared_attn"] = _dense_block_shapes(cfg)
    elif cfg.family == "encdec":
        p["enc_layers"] = _dense_block_shapes(cfg, (cfg.n_enc_layers,))
        p["enc_norm"] = _const((d,), 1.0)
        p["layers"] = _encdec_dec_block_shapes(cfg, Ln)
    else:
        raise ValueError(cfg.family)
    return p


def _spec_map(fn, tree):
    return {k: (_spec_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def init_params(cfg, *, seed: int = 0, device=None, mesh=None,
                style: str = "contraction") -> LM:
    """Random parameters (the reference's scales) on ``device`` (default
    ``cuda``), drawn leaf by leaf in sorted-path order from a generator
    seeded with ``seed``.

    Under ``mesh`` (a ``DeviceMesh``) the whole tensors are drawn as
    without one, then each rank keeps its shard by
    :func:`repro_torch.train.sharding.param_specs` (``style``), so the
    weights equal the unsharded ones whatever the mesh: the port's
    counterpart of the reference's ``_ensure_sharding_invariant_rng``."""
    dev = dv.resolve(device)
    gen = None
    if dev.type != "meta":      # meta tensors (the dry-run) hold no draws
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    shapes = param_shapes(cfg)
    drawn = {}
    for path, (shape, kind, scale) in tree_leaves(shapes):
        if kind == "normal":
            t = torch.randn(shape, generator=gen, device=dev).mul_(scale)
        elif kind == "a_log":
            N = shape[-1]
            t = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev)).expand(shape).clone()
        else:
            t = torch.full(shape, scale, dtype=torch.float32, device=dev)
        drawn[path] = t
    tree = tree_unflatten(shapes, drawn)
    if mesh is not None:
        from repro_torch.train import sharding as SH
        tree = SH.distribute(tree, SH.param_specs(cfg, tree, mesh, style),
                             mesh)
    return LM(cfg, tree)


def abstract_params(cfg) -> Dict[str, Any]:
    """The parameter tree as float32 tensors on the ``meta`` device."""
    return _spec_map(lambda s: torch.empty(s[0], dtype=torch.float32,
                                           device="meta"), param_shapes(cfg))


# --------------------------------------------------------------------------
# decode caches
# --------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_seq: int, *, device=None,
               mesh=None) -> Dict[str, Any]:
    """Zeroed decode caches on ``device`` (default ``cuda``; ``"meta"``
    gives the shapes alone).  k/v and conv states in the compute dtype,
    SSM states in float32.  Under ``mesh`` each rank allocates its own
    shard of every leaf, placed by
    :func:`repro_torch.train.sharding.cache_specs`."""
    if mesh is not None:
        return _placed_cache(cfg, batch, max_seq, dv.resolve(device), mesh)
    dev = dv.resolve(device)
    cd = compute_dtype()
    Hkv, hd, Ld = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def zeros(shape, dtype=cd):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def attn_cache(n, seq):
        c = {"k": zeros((n, batch, seq, Hkv, hd)),
             "v": zeros((n, batch, seq, Hkv, hd))}
        if cfg.swa_window and cfg.swa_window < max_seq:
            # ring-slot absolute positions
            c["pos"] = torch.full((n, seq), -1, dtype=torch.int32,
                                  device=dev)
        return c

    def ssm_cache(n):
        K = S.CONV_K - 1
        if cfg.ssm_version == 1:
            return {"ssm": zeros((n, batch, cfg.d_inner, cfg.ssm_state),
                                 torch.float32),
                    "conv": zeros((n, batch, K, cfg.d_inner))}
        nh = cfg.d_inner // cfg.ssm_head_dim
        return {"ssm": zeros((n, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                             torch.float32),
                "conv": {"x": zeros((n, batch, K, cfg.d_inner)),
                         "B": zeros((n, batch, K, cfg.ssm_state)),
                         "C": zeros((n, batch, K, cfg.ssm_state))}}

    if cfg.family in ("dense", "moe", "vlm"):
        seq = min(max_seq, cfg.swa_window) if cfg.swa_window else max_seq
        return {"attn": attn_cache(Ld, seq)}
    if cfg.family == "ssm":
        return {"ssm": ssm_cache(Ld)}
    if cfg.family == "hybrid":
        return {"ssm": ssm_cache(Ld),
                "attn": attn_cache(cfg.n_layers // cfg.hybrid_period,
                                   max_seq)}
    if cfg.family == "encdec":
        return {"attn": attn_cache(Ld, max_seq),
                "cross_k": zeros((Ld, batch, cfg.enc_seq, Hkv, hd)),
                "cross_v": zeros((Ld, batch, cfg.enc_seq, Hkv, hd))}
    raise ValueError(cfg.family)


def _placed_cache(cfg, batch, max_seq, dev, mesh):
    from torch.distributed import tensor as dt
    from repro_torch.train import sharding as SH
    SH.check_mesh(mesh, dev)
    shapes = init_cache(cfg, batch, max_seq, device="meta")
    specs = SH.cache_specs(cfg, batch, mesh, shapes)

    def leaf(path, m):
        spec = specs
        for k in path:
            spec = spec[k]
        fill = -1 if path[-1] == "pos" else 0
        pl = SH.placements(mesh, spec)
        if dev.type == "meta":
            return dt.distribute_tensor(torch.full(
                m.shape, fill, dtype=m.dtype, device=dev), mesh, pl)
        return dt.full(m.shape, fill, dtype=m.dtype, device_mesh=mesh,
                       placements=pl)

    return tree_unflatten(shapes, {p: leaf(p, m)
                                   for p, m in tree_leaves(shapes)})


def _index(tree, i):
    """Layer ``i`` of a stacked tree: views, so writes reach the stack."""
    if tree is None:
        return None
    return tree_map(lambda t: t[i], tree)


def _write(dst, src):
    """Copy a layer's new cache into its slot of the stacked cache (in
    place; leaves that already are the slot are skipped)."""
    for (_, d), (_, s) in zip(tree_leaves(dst), tree_leaves(src)):
        if s is not d:
            d.copy_(s)


# --------------------------------------------------------------------------
# ring-buffer windowed KV (SWA decode)
# --------------------------------------------------------------------------

def _swa_decode_attn(p, cfg, x, cache_k, cache_v, cache_slot_pos, cache_pos):
    """One token's attention against a ring-buffer window cache, written
    in place.  cache_k/v: (B, W, Hkv, hd); cache_slot_pos: (W,) absolute
    positions (-1: empty)."""
    B = x.shape[0]
    W = cache_k.shape[1]
    H, hd = p["wq"].shape[1:]
    Hkv = p["wk"].shape[1]
    cd = compute_dtype()
    pos = int(cache_pos)
    pos_b = torch.full((B, 1), pos, device=x.device)
    xq = mm("bsd,dnh->bsnh", x, p["wq"], cd)
    xk = mm("bsd,dkh->bskh", x, p["wk"], cd)
    xv = mm("bsd,dkh->bskh", x, p["wv"], cd)
    if cfg.qk_norm:
        xq = rms_norm(xq, p["q_norm"], cfg.norm_eps)
        xk = rms_norm(xk, p["k_norm"], cfg.norm_eps)
    xq = L.rope(xq, pos_b, cfg.rope_theta)
    xk = L.rope(xk, pos_b, cfg.rope_theta)

    slot = pos % W
    L.store_seq(cache_k, slot, xk)
    L.store_seq(cache_v, slot, xv)
    cache_slot_pos[slot:slot + 1].fill_(pos)

    k_rep = L.repeat_kv(L.gather_seq(cache_k), H // Hkv)
    v_rep = L.repeat_kv(L.gather_seq(cache_v), H // Hkv)
    logits = dot("bsnh,bwnh->bsnw", xq, k_rep) / (hd ** 0.5)
    valid = (cache_slot_pos >= 0) & (cache_slot_pos <= pos) \
        & (cache_slot_pos > pos - cfg.swa_window)
    logits = torch.where(valid[None, None, None, :], logits, float("-inf"))
    prob = torch.softmax(logits, dim=-1)
    out = dot("bsnw,bwnh->bsnh", prob.to(v_rep.dtype), v_rep, cd)
    return mm("bsnh,nhd->bsd", out, p["wo"], x.dtype)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _write_prefill_cache(cache, kv):
    """Write a prompt's post-rope k/v (B, S, Hkv, hd) into a decode cache
    in place."""
    S_ = kv["k"].shape[1]
    if "pos" in cache:  # ring buffer (SWA): keep the last min(S, W) tokens
        W = cache["k"].shape[1]
        keep = min(S_, W)
        # positions S_-keep .. S_-1 land in slots p % W: at most two runs
        p0 = S_ - keep
        while p0 < S_:
            slot = p0 % W
            n = min(S_ - p0, W - slot)
            for name in ("k", "v"):
                L.store_seq(cache[name], slot, kv[name][:, p0:p0 + n])
            cache["pos"][slot:slot + n].copy_(torch.arange(
                p0, p0 + n, dtype=torch.int32, device=kv["k"].device))
            p0 += n
        return
    L.store_seq(cache["k"], 0, kv["k"])
    L.store_seq(cache["v"], 0, kv["v"])


def _self_attention(p, h_in, cfg, positions, cache, cache_pos, kv_chunk):
    """The dense block's attention in its three cache modes; writes the
    cache in place."""
    S_ = h_in.shape[1]
    if cache is not None and S_ == 1 and "pos" in cache:
        return _swa_decode_attn(p, cfg, h_in, cache["k"], cache["v"],
                                cache["pos"], cache_pos)
    if cache is not None and S_ == 1:
        h, _ = L.attention(p, h_in, cfg=cfg, positions=positions,
                           kv_cache=cache, cache_pos=cache_pos,
                           kv_chunk=kv_chunk)
        return h
    h, kv = L.attention(p, h_in, cfg=cfg, positions=positions,
                        kv_chunk=kv_chunk)
    if cache is not None:   # prefill: chunked self-attention + one write
        _write_prefill_cache(cache, kv)
    return h


def _dense_block(p, x, cfg, positions, cache, cache_pos, kv_chunk):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _self_attention(p["attn"], h_in, cfg, positions, cache,
                            cache_pos, kv_chunk)
    h_in = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        h, aux = L.moe(p["moe"], h_in, cfg)
    else:
        h = L.swiglu(p["mlp"], h_in)
    return x + h, aux


def _ssm_block(p, x, cfg, cache):
    mixer = S.mamba1 if cfg.ssm_version == 1 else S.mamba2
    h, new_cache = mixer(p["mixer"], rms_norm(x, p["ln"], cfg.norm_eps), cfg,
                         cache)
    if cache is not None:
        _write(cache, new_cache)
    return x + h


def _encdec_block(p, x, cfg, positions, cache, cache_pos, kv_chunk, enc_out,
                  cross):
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _self_attention(p["attn"], h_in, cfg, positions, cache,
                            cache_pos, kv_chunk)
    cd = compute_dtype()
    if enc_out is not None:
        ck = mm("bsd,dkh->bskh", enc_out, p["xattn"]["wk"], cd)
        cv = mm("bsd,dkh->bskh", enc_out, p["xattn"]["wv"], cd)
        if cross is not None:   # prefill caches the cross k/v
            cross[0].copy_(ck)
            cross[1].copy_(cv)
    else:
        ck, cv = cross
    h_in = rms_norm(x, p["ln_x"], cfg.norm_eps)
    h, _ = L.attention(p["xattn"], h_in, cfg=cfg, positions=positions,
                       cross_kv=(ck, cv), kv_chunk=kv_chunk)
    x = x + h
    return x + L.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _run(fn, remat, *args):
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --------------------------------------------------------------------------
# family forwards.  All return (hidden, caches, aux_loss).
# --------------------------------------------------------------------------

def forward(params, cfg, x, positions, caches=None, cache_pos=None,
            enc_out=None, remat=False, kv_chunk=512, act_spec=None):
    """Run the layer stack.  x: (B, S, d) hidden states (embedded).

    caches: the stacked decode caches of :func:`init_cache` (None in
    training), written in place by prefill (``cache_pos`` 0) and decode.
    ``act_spec``: under a mesh, the residual stream is pinned to it at
    every layer boundary (:func:`repro_torch.models.layers.constrain`).
    Returns (hidden, caches, aux).
    """
    params = tree_of(params)
    fam = cfg.family
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if fam in ("dense", "moe", "vlm"):
        c = caches["attn"] if caches is not None else None
        for i in range(cfg.n_layers):
            def body(p, x_, c_=_index(c, i)):
                return _dense_block(p, x_, cfg, positions, c_, cache_pos,
                                    kv_chunk)
            x = L.constrain(x, act_spec)
            x, a = _run(body, remat, _index(params["layers"], i), x)
            aux = aux + a
        return x, caches, aux

    if fam in ("ssm", "hybrid"):
        sc = caches["ssm"] if caches is not None else None
        ac = caches.get("attn") if caches is not None else None
        period = cfg.hybrid_period if fam == "hybrid" else 0
        # the reference runs n_layers // period whole groups
        n_run = cfg.n_layers // period * period if period else cfg.n_layers
        for i in range(n_run):
            def body(p, x_, c_=_index(sc, i)):
                return _ssm_block(p, x_, cfg, c_)
            x = L.constrain(x, act_spec)
            x = _run(body, remat, _index(params["layers"], i), x)
            if period and (i + 1) % period == 0:
                # the weight-shared attention block after each group
                x = L.constrain(x, act_spec)
                x, a = _dense_block(params["shared_attn"], x, cfg, positions,
                                    _index(ac, i // period), cache_pos,
                                    kv_chunk)
                aux = aux + a
        return x, caches, aux

    if fam == "encdec":
        c = caches["attn"] if caches is not None else None
        for i in range(cfg.n_layers):
            cross = None if caches is None else (caches["cross_k"][i],
                                                 caches["cross_v"][i])

            def body(p, x_, c_=_index(c, i), cross_=cross):
                return _encdec_block(p, x_, cfg, positions, c_, cache_pos,
                                     kv_chunk, enc_out, cross_)
            x = L.constrain(x, act_spec)
            x = _run(body, remat, _index(params["layers"], i), x)
        return x, caches, aux

    raise ValueError(fam)


def encode(params, cfg, enc_in, remat=False, kv_chunk=512, act_spec=None):
    """Encoder stack (whisper): enc_in (B, Senc, d) stub frame embeddings."""
    params = tree_of(params)
    positions = torch.arange(enc_in.shape[1], device=enc_in.device)

    def body(p, x):
        h, _ = L.attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                           cfg=cfg, positions=positions, causal=False,
                           kv_chunk=kv_chunk)
        x = x + h
        return x + L.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))

    x = enc_in
    for i in range(cfg.n_enc_layers):
        x = L.constrain(x, act_spec)
        x = _run(body, remat, _index(params["enc_layers"], i), x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def n_params(tree) -> int:
    return sum(math.prod(t.shape) for _, t in tree_leaves(tree_of(tree)))
