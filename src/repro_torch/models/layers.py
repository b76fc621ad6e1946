"""Transformer building blocks (the reference's ``models/layers.py``).

Pure functions over nested dicts of tensors with the reference's key
names and shapes, so :mod:`repro_torch.convert` carries parameters across
one to one.  The algorithms are the reference's, in its order:

* attention is chunked over the KV axis with an online softmax (a Python
  loop over chunks, the largest divisor of the KV length not above
  ``kv_chunk``), so the S x S logits are never materialised;
* GQA repeats each KV chunk to the query heads;
* MoE is grouped first-come capacity dispatch with a gather and a
  scatter-add combine, and the Switch aux loss;
* matmuls take their inputs in the compute dtype (bf16 by default) and,
  where the reference asks for ``preferred_element_type=float32`` and
  keeps the result, return it in float32 (:func:`mm`, :func:`dot`).

Under a mesh the parameters are ``torch.distributed.tensor`` DTensors:
the products (:func:`_sharded_product`), attention (:func:`_sharded_scan`),
the cache writes (:func:`store_seq`) and the MoE combine run on local
shards around explicit redistributes, every other op through DTensor's
sharding rules; :func:`constrain` pins the residual stream's placements
at each layer boundary, and is the identity without a mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["set_compute_dtype", "compute_dtype", "cast", "is_dtensor",
           "constrain", "store_seq", "gather_seq", "dot",
           "mm",
           "set_lean_internals", "rms_norm", "rope", "repeat_kv",
           "attention", "swiglu", "set_moe_combine_dtype", "moe", "top_k"]

_COMPUTE_DTYPE = [torch.bfloat16]


def set_compute_dtype(dtype):
    """bf16 (the default) on the card; float32 for the CPU parity tests."""
    _COMPUTE_DTYPE[0] = dtype


def compute_dtype():
    return _COMPUTE_DTYPE[0]


def cast(x):
    return x.to(_COMPUTE_DTYPE[0])


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, spec=None):
    """Pin a spec (:class:`repro_torch.train.sharding.Spec`) on an
    activation: the reference's ``with_sharding_constraint`` on the
    residual stream at every layer boundary, here a ``redistribute`` of
    the DTensor to the spec's placements on its own mesh.  The identity
    when ``spec`` is None or ``x`` is a plain tensor (no mesh)."""
    if spec is None or not is_dtensor(x):
        return x
    from repro_torch.train.sharding import placements
    pl = placements(x.device_mesh, spec)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def _seq_sharded(t) -> bool:
    return is_dtensor(t) and any(p.is_shard(1) for p in t.placements)


def store_seq(dst, start: int, src):
    """``dst[:, start:start + n] = src`` in place along axis 1 (a cache's
    sequence axis).  Where a mesh shards that axis (``cache_specs``'
    fallback when the KV heads do not divide TP), DTensor's slice rule
    would gather the cache into a copy and write there: each rank writes
    the part of the range its own shard holds, from ``src`` replicated
    along axis 1 (an explicit redistribute)."""
    n = src.shape[1]
    if not _seq_sharded(dst):
        dst[:, start:start + n] = src
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = dst.device_mesh
    src = src.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in dst.placements]).to_local()
    loc = dst.to_local()
    _, off = compute_local_shape_and_global_offset(dst.shape, mesh,
                                                   dst.placements)
    lo = max(start, off[1])
    hi = min(start + n, off[1] + loc.shape[1])
    if lo < hi:
        loc[:, lo - off[1]:hi - off[1]] = \
            src[:, lo - start:hi - start].to(loc.dtype)


def gather_seq(t):
    """A cache replicated along its sequence axis (axis 1) where a mesh
    shards it: decode attends over the whole cache, gathered once a layer
    (an explicit redistribute; DTensor would otherwise gather it again for
    every KV chunk's slice)."""
    if not _seq_sharded(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(1)
                                          else p for p in t.placements])


class _NarrowDot(torch.autograd.Function):
    """``einsum(eq, a, b)`` of operands rounded to ``narrow`` (the compute
    dtype, or None to take them as they are), accumulated in float32 and
    returned in ``out_dtype`` without an intermediate bf16 rounding.

    Saves the operands as given (a parameter is not copied: its bf16 cast
    is redone in the backward), so training holds no narrow copy of a
    weight.  A float32 product of bf16 operands upcasts them: bf16 values
    are exact in TF32, so on the card it runs on the tensor cores with
    TF32 allowed for that product alone.  A bf16 result on the card is a
    bf16 GEMM (float32 accumulation, one rounding).  In the backward each
    operand's gradient is rounded to its narrow dtype and returned in the
    operand's own (the reference's cast transpose); on the card its
    products are bf16 GEMMs of the incoming gradient rounded to bf16, on
    the CPU float32 products."""

    @staticmethod
    def forward(ctx, eq, a, b, out_dtype, narrow):
        ctx.eq, ctx.narrow = eq, narrow
        ctx.save_for_backward(a, b)
        return _product(eq, _narrow(a, narrow), _narrow(b, narrow),
                        out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        an, bn = _narrow(a, ctx.narrow), _narrow(b, ctx.narrow)
        ins, out = ctx.eq.split("->")
        ea, eb = ins.split(",")
        if g.is_cuda:
            g = g.to(an.dtype)
        ga = gb = None
        if ctx.needs_input_grad[1]:
            ga = _product(f"{out},{eb}->{ea}", g, bn, an.dtype).to(a.dtype)
        if ctx.needs_input_grad[2]:
            gb = _product(f"{ea},{out}->{eb}", an, g, bn.dtype).to(b.dtype)
        return None, ga, gb, None, None


def _narrow(x, dtype):
    return x if dtype is None else x.to(dtype)


def _product(eq, a, b, out_dtype):
    if a.dtype == b.dtype == out_dtype and (a.is_cuda or
                                             out_dtype == torch.float32):
        return torch.einsum(eq, a, b)
    if not a.is_cuda:
        return torch.einsum(eq, a.float(), b.float()).to(out_dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.einsum(eq, a.float(), b.float()).to(out_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _letter(p, term):
    """The einsum letter a plain ``Shard`` splits, else None."""
    from torch.distributed.tensor import Shard
    return term[p.dim] if type(p) is Shard else None


def _sharded_product(fn, eq, a, b, *args):
    """``fn(eq, a, b, *args)`` (:func:`dot` or :func:`mm`) of DTensors,
    each rank running the einsum on its local operands.

    The plan, per mesh dim: on the model (TP) axis the letter the second
    operand (the weight) splits, else the one the first (the activation)
    splits; on the data axes the activation's first, then the weight's
    -- weights keep their tensor-parallel split and are gathered over
    the data axes (FSDP), activations keep their batch split and are
    gathered over the model axis where they were sequence-split
    (Megatron's sequence parallelism).  Each operand is explicitly
    redistributed to split that letter where it has it and to be whole
    otherwise (a weight's FSDP all-gather, a partial sum's reduction);
    the result splits the letter where the output keeps it and is
    partial where it is summed.  An
    operand whole on a mesh dim that splits the result gets its gradient
    as a partial sum there.  (Through DTensor's rules the einsum's
    reshapes can split an output axis the mesh does not divide, e.g.
    8 KV heads over a 16-wide model axis, and fail.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out_t = eq.split("->")
    ta, tb = ins.split(",")
    mesh = next(t for t in (a, b) if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    a, b = (t if is_dtensor(t) else DTensor.from_local(t, mesh, rep)
            for t in (a, b))
    pa, pb, po = [], [], []
    for name, xa, xb in zip(mesh.mesh_dim_names, a.placements,
                            b.placements):
        if name == "model":
            L = _letter(xb, tb) or _letter(xa, ta)
        else:
            L = _letter(xa, ta) or _letter(xb, tb)
        pa.append(Shard(ta.index(L)) if L and L in ta else Replicate())
        pb.append(Shard(tb.index(L)) if L and L in tb else Replicate())
        po.append(Replicate() if L is None else
                  Shard(out_t.index(L)) if L in out_t else Partial())

    def grad_pl(pl):
        return [Partial() if p == Replicate() and o != Replicate() else p
                for p, o in zip(pl, po)]

    la = a.redistribute(mesh, pa).to_local(grad_placements=grad_pl(pa))
    lb = b.redistribute(mesh, pb).to_local(grad_placements=grad_pl(pb))
    size = dict(zip(ta, a.shape))
    size.update(zip(tb, b.shape))
    shape = torch.Size(size[c] for c in out_t)
    return DTensor.from_local(fn(eq, la, lb, *args), mesh, po, shape=shape,
                              stride=_contiguous(shape))


def _contiguous(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def dot(eq, a, b, dtype=torch.float32):
    """``einsum(eq, a, b)`` accumulated in float32 and returned in
    ``dtype`` (the reference's ``einsum(..., preferred_element_type=
    float32).astype(dtype)``), the operands taken as given.  DTensors
    go through :func:`_sharded_product`."""
    if is_dtensor(a) or is_dtensor(b):
        return _sharded_product(dot, eq, a, b, dtype)
    if a.dtype == b.dtype == torch.float32:
        return torch.einsum(eq, a, b).to(dtype)
    return _NarrowDot.apply(eq, a, b, dtype, None)


def mm(eq, a, b, dtype=torch.float32):
    """:func:`dot` of ``cast(a)`` and ``cast(b)``: the reference's
    ``einsum(cast(a), cast(b), preferred_element_type=float32)
    .astype(dtype)``, with the casts inside the product (no narrow copy
    of a weight is kept for the backward).  DTensors go through
    :func:`_sharded_product`."""
    if is_dtensor(a) or is_dtensor(b):
        return _sharded_product(mm, eq, a, b, dtype)
    cd = compute_dtype()
    if cd == a.dtype == b.dtype == torch.float32:
        return torch.einsum(eq, a, b).to(dtype)
    return _NarrowDot.apply(eq, a, b, dtype, cd)


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------

# lean mode: no float32 copies of residual-sized tensors in norms and of
# attention probabilities (the variance reduction stays float32)
_LEAN_INTERNALS = [False]


def set_lean_internals(on: bool):
    _LEAN_INTERNALS[0] = bool(on)


def rms_norm(x, scale, eps=1e-5):
    if _LEAN_INTERNALS[0]:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(x.dtype)
        return x * inv * scale.to(x.dtype)
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope(x, positions, theta=1e4):
    """x: (B, S, *head_axes, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    for _ in range(x.ndim - 3):     # axes between S and hd
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def repeat_kv(k, n_rep):
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd), each head repeated in
    place (``jnp.repeat``); done per KV chunk."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _largest_divisor(n, at_most):
    c = min(at_most, n)
    while n % c:
        c -= 1
    return c


def _attention_placements(q, k):
    """Per mesh dim, the placement the attention runs its local scan
    under: the batch axis (0) split where q's or k's is, else the head
    axis (2) where k's is (q's local heads then use exactly the local KV
    heads: H/Hkv = n_rep on every shard); everything else is gathered
    (sequence and head_dim, and any partial sum).  A decode cache is
    never gathered over a mesh axis that splits its batch or heads."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for pq, pk in zip(q.placements, k.placements):
        if Shard(0) in (pq, pk):
            out.append(Shard(0))
        elif pk == Shard(2):
            out.append(pk)
        else:
            out.append(Replicate())
    return out


def _sharded_scan(q, k, v, q_pos, kv_pos, **kw):
    """:func:`_online_softmax_scan` under a mesh.  Attention is
    independent across batch rows and heads, so q, k and v are
    redistributed explicitly to :func:`_attention_placements` and each
    rank runs the scan on its local rows and heads as plain tensors; the
    output is placed as q then is.  (Through DTensor's rules the
    einsums' reshapes, which merge the batch and head axes, would gather
    every KV chunk over the head-sharded mesh axis.)"""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    q, k, v = (t if is_dtensor(t) else DTensor.from_local(t, mesh, rep)
               for t in (q, k, v))
    pl = _attention_placements(q, k)
    q, k, v = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
    out = _online_softmax_scan(q, k, v, q_pos, kv_pos, **kw)
    return DTensor.from_local(out, mesh, pl)


def _online_softmax_scan(q, k, v, q_pos, kv_pos, *, causal, window, kv_chunk,
                         n_rep=1):
    """Chunked attention with a running (max, sum, acc) over KV chunks.

    q: (B, S, H, hd); k, v: (B, Skv, Hkv, hd) with H = Hkv * n_rep;
    q_pos: (S,), kv_pos: (Skv,) absolute positions for the masks.
    Returns (B, S, H, hd) in q's dtype.  A fully masked row gives 0.
    """
    if is_dtensor(q) or is_dtensor(k):
        return _sharded_scan(q, k, v, q_pos, kv_pos, causal=causal,
                             window=window, kv_chunk=kv_chunk, n_rep=n_rep)
    B, S, H, hd = q.shape
    Skv = k.shape[1]
    kv_chunk = _largest_divisor(Skv, kv_chunk)
    scale = 1.0 / (hd ** 0.5)
    ninf = float("-inf")
    m = torch.full((B, S, H), ninf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Skv, kv_chunk):
        kj = repeat_kv(k[:, c0:c0 + kv_chunk], n_rep)
        vj = repeat_kv(v[:, c0:c0 + kv_chunk], n_rep)
        pj = kv_pos[c0:c0 + kv_chunk]
        logits = dot("bshd,bchd->bshc", q, kj) * scale
        mask = torch.ones((S, kv_chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (q_pos[:, None] >= pj[None, :])
        if window > 0:
            mask = mask & (q_pos[:, None] - pj[None, :] < window)
        logits = torch.where(mask[None, :, None, :], logits, ninf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        if _LEAN_INTERNALS[0]:
            p = p.to(vj.dtype)
        l = l * corr + p.float().sum(dim=-1)
        pv = dot("bshc,bchd->bshd", p.to(vj.dtype), vj)
        acc = acc * corr[..., None] + pv
        m = m_safe
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def attention(params, x, *, cfg, positions, kv_cache=None, cache_pos=None,
              cross_kv=None, causal=True, kv_chunk=512):
    """Multi-head attention with GQA, an optional SWA window, qk-norm and
    RoPE.

    params: {wq (d, H, hd), wk (d, Hkv, hd), wv, wo (H, hd, d),
             [q_norm, k_norm (hd,)]}
    modes:
      * train/prefill: kv_cache None -> self attention over x; returns the
        post-rope k/v as the new cache so prefill can write them;
      * decode: kv_cache = dict(k, v) (B, Smax, Hkv, hd), cache_pos an int:
        this step's k/v are written into the cache IN PLACE at cache_pos
        (the counterpart of the reference's donated cache);
      * cross: cross_kv = (k, v) precomputed encoder keys/values.
    Returns (out, new_cache).
    """
    H, hd = params["wq"].shape[1:]
    Hkv = params["wk"].shape[1]
    n_rep = H // Hkv
    cd = compute_dtype()
    xq = mm("bsd,dnh->bsnh", x, params["wq"], cd)
    if cross_kv is None:
        xk = mm("bsd,dkh->bskh", x, params["wk"], cd)
        xv = mm("bsd,dkh->bskh", x, params["wv"], cd)
    else:
        xk, xv = cross_kv

    if cfg.qk_norm:
        xq = rms_norm(xq, params["q_norm"], cfg.norm_eps)
        if cross_kv is None:
            xk = rms_norm(xk, params["k_norm"], cfg.norm_eps)

    if cross_kv is None:
        xq = rope(xq, positions, cfg.rope_theta)
        xk = rope(xk, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        pos = int(cache_pos)
        store_seq(kv_cache["k"], pos, xk)
        store_seq(kv_cache["v"], pos, xv)
        new_cache = kv_cache
        Smax = kv_cache["k"].shape[1]
        q_pos = torch.full((1,), pos, device=x.device)
        kv_pos = torch.arange(Smax, device=x.device)
        out = _online_softmax_scan(
            xq, kv_cache["k"], kv_cache["v"], q_pos, kv_pos, causal=True,
            window=cfg.swa_window, kv_chunk=kv_chunk, n_rep=n_rep)
    elif cross_kv is not None:
        out = _online_softmax_scan(
            xq, xk, xv, positions, torch.arange(xk.shape[1], device=x.device),
            causal=False, window=0, kv_chunk=kv_chunk, n_rep=n_rep)
    else:
        out = _online_softmax_scan(
            xq, xk, xv, positions, positions, causal=causal,
            window=cfg.swa_window, kv_chunk=kv_chunk, n_rep=n_rep)
        new_cache = {"k": xk, "v": xv}

    proj = mm("bsnh,nhd->bsd", out, params["wo"], x.dtype)
    return proj, new_cache


# --------------------------------------------------------------------------
# dense MLP
# --------------------------------------------------------------------------

def swiglu(params, x):
    h = mm("bsd,df->bsf", x, params["w_gate"])
    u = mm("bsd,df->bsf", x, params["w_up"])
    h = F.silu(h) * u
    return mm("bsf,fd->bsd", h, params["w_down"], x.dtype)


# --------------------------------------------------------------------------
# mixture of experts: grouped capacity dispatch
# --------------------------------------------------------------------------

# dtype of the MoE combine buffer (the reference's all-reduce payload under
# pjit); float32 by default
_MOE_COMBINE_DTYPE = [torch.float32]


def set_moe_combine_dtype(dtype):
    _MOE_COMBINE_DTYPE[0] = dtype


def top_k(x, k):
    """``jax.lax.top_k`` along the last axis: the k largest, ties broken
    by the lower index (a stable descending sort; ``torch.topk`` does not
    promise an order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rows_only(t):
    """Under a mesh, ``t`` split along axis 0 at most (the groups) and
    contiguous: the combine merges the expert and capacity axes, which
    DTensor's reshape cannot do on a split or strided local tensor, so
    they are gathered explicitly first."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    t = t.redistribute(t.device_mesh, [
        p if type(p) is Shard and p.dim == 0 else Replicate()
        for p in t.placements])
    return t.contiguous()


def moe(params, x, cfg, group_size: int = 4096):
    """Top-k MoE with GShard-style first-come capacity and gather dispatch.

    x: (B, S, d).  Tokens are flattened and regrouped into groups of
    ``group_size``; each expert keeps its first ``cap`` tokens of a group.
    Returns (out, aux_loss).
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    Sg = min(group_size, T)
    Gn = T // Sg
    if T % Sg:
        raise ValueError(f"moe: {T} tokens do not split into groups of {Sg}")
    xt = x.reshape(Gn, Sg, d)

    logits = mm("gsd,de->gse", xt, params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, k)                      # (G, Sg, k)
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)

    # gate (G, Sg, E): the normalised prob where selected, else 0
    gate = torch.zeros((Gn, Sg, E), dtype=torch.float32, device=x.device)
    for i in range(k):
        gate = gate + F.one_hot(top_idx[..., i], E).float() \
            * top_vals[..., i:i + 1]
    assigned = gate > 0

    # Switch-style load-balance loss
    me = assigned.float().mean(dim=(0, 1))
    pe = probs.mean(dim=(0, 1))
    aux = E * torch.sum(me * pe)

    cap = min(max(1, int(Sg * k / E * cfg.moe_capacity_factor)), Sg)
    # first-come keep: rank tokens by arrival within each expert; the
    # unassigned tokens all score -inf and tie, so the stable sort matters
    pos = torch.cumsum(assigned.to(torch.int32), dim=1) - 1  # (G, Sg, E)
    score = torch.where(assigned, -pos.float(), float("-inf"))
    sel_score, sel_idx = top_k(score.transpose(1, 2), cap)  # (G, E, cap)
    sel_valid = torch.isfinite(sel_score)

    # dispatch: gather tokens, xe: (G, E, cap, d)
    grp = torch.arange(Gn, device=x.device)[:, None, None]
    xe = torch.where(sel_valid[..., None], xt[grp, sel_idx], 0.0)

    acc_dt = compute_dtype() if _LEAN_INTERNALS[0] else torch.float32
    h = mm("gecd,edf->gecf", xe, params["w_gate"], acc_dt)
    u = mm("gecd,edf->gecf", xe, params["w_up"], acc_dt)
    h = F.silu(h.float()) * u.float()
    ye = mm("gecf,efd->gecd", h, params["w_down"])

    # combine: weight by the token's gate for THIS expert, scatter-add.
    # JAX drops out-of-range scatter indices and torch raises on them, so
    # the slots past an expert's intake are masked here explicitly: they
    # add exact zeros at a valid index
    w_tok = torch.gather(gate.transpose(1, 2), 2, sel_idx)
    ye = ye * torch.where(sel_valid, w_tok, 0.0)[..., None]
    idx = _rows_only(torch.where(sel_valid, sel_idx, 0)).reshape(
        Gn, E * cap)
    cdt = _MOE_COMBINE_DTYPE[0]
    out = torch.zeros((Gn, Sg, d), dtype=cdt, device=x.device)
    out = out.scatter_add(1, idx[..., None].expand(Gn, E * cap, d),
                          _rows_only(ye).reshape(Gn, E * cap, d).to(cdt))
    return out.reshape(B, S, d).to(x.dtype), aux
