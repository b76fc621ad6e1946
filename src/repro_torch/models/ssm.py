"""State-space mixers: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2), the
reference's ``models/ssm.py``.

Both are chunked scans: the sequence is cut into chunks (the largest
divisor of S not above ``chunk``); inside a chunk the linear recurrence
h_t = a_t * h_{t-1} + b_t is solved by a log-step (Hillis-Steele) prefix
composition of the affine maps (the reference uses
``lax.associative_scan``, which torch lacks: the composition is the same,
its float32 order is not), and only the carried state crosses chunk
boundaries.  Decode is the exact one-step recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _largest_divisor, compute_dtype, dot, mm

__all__ = ["CONV_K", "set_mamba2_impl", "mamba2_impl", "causal_conv",
           "mamba1", "mamba2"]

CONV_K = 4  # depthwise conv kernel width (mamba standard)

# mamba2 chunk solver: "scan" solves the (B,cs,nh,hd,N) recurrence; "ssd"
# is the chunked quadratic form (intra-chunk outputs by (cs x cs)
# attention-like products, no (B,cs,nh,hd,N) tensor)
_MAMBA2_IMPL = ["scan"]


def set_mamba2_impl(name: str):
    if name not in ("scan", "ssd"):
        raise ValueError(f"mamba2 solver {name!r}: 'scan' or 'ssd'")
    _MAMBA2_IMPL[0] = name


def mamba2_impl() -> str:
    return _MAMBA2_IMPL[0]


def _solve_chunk(a, b, state):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from ``state``.  a, b: (B, cs,
    ...) (a may broadcast against b); state (B, ...).  Returns (h: (B, cs,
    ...), new_state).  Hillis-Steele: after the step at offset o, entry t
    holds the composition of entries t-2o+1..t."""
    a = a.expand_as(b)
    cs = b.shape[1]
    off = 1
    while off < cs:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], b_cur + a_cur * b_prev], dim=1)
        off *= 2
    h = a * state[:, None] + b
    return h, h[:, -1]


# --------------------------------------------------------------------------
# depthwise causal conv (kernel CONV_K) as shifted adds
# --------------------------------------------------------------------------

def causal_conv(x, w, conv_state=None):
    """x: (B, S, c), w: (CONV_K, c); conv_state: (B, CONV_K-1, c) for
    decode continuity.  Returns (y, new_conv_state)."""
    B, S, c = x.shape
    if conv_state is None:
        conv_state = torch.zeros((B, CONV_K - 1, c), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros((B, S, c), dtype=torch.float32, device=x.device)
    for i in range(CONV_K):
        y = y + xp[:, i:i + S].float() * w[i]
    return F.silu(y).to(x.dtype), xp[:, -(CONV_K - 1):]


# --------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# --------------------------------------------------------------------------

def _mamba1_abc(p, x_conv):
    """x_conv (B, cs, di) -> a, b (B, cs, di, N) and C (B, cs, N)."""
    dt_rank = p["dt_proj"].shape[0]
    N = (p["x_proj"].shape[1] - dt_rank) // 2
    proj = mm("bsd,de->bse", x_conv, p["x_proj"])
    dt_r, Bm, Cm = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dot("bsr,rd->bsd", dt_r, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                  # (di, N)
    a = torch.exp(dt[..., None] * A[None, None])
    b = (dt * x_conv.float())[..., None] * Bm[:, :, None, :]
    return a, b, Cm


def mamba1(p, x, cfg, cache=None, chunk=128):
    """x: (B, S, d) -> (B, S, d).  cache: {"ssm", "conv"} for decode.
    Returns (out, {"ssm", "conv"})."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    xi = mm("bsd,de->bse", x, p["in_proj"], compute_dtype())
    x_in, z = torch.chunk(xi, 2, dim=-1)
    x_conv, new_conv = causal_conv(
        x_in, p["conv_w"], cache["conv"] if cache is not None else None)
    state = cache["ssm"] if cache is not None else torch.zeros(
        (B, di, N), dtype=torch.float32, device=x.device)

    if S == 1:  # decode: the exact single-step recurrence
        a, b, Cm = _mamba1_abc(p, x_conv)
        state = a[:, 0] * state + b[:, 0]                      # (B, di, N)
        y = torch.einsum("bdn,bn->bd", state, Cm[:, 0])[:, None]
    else:
        cs = _largest_divisor(S, chunk)
        ys = []
        for c0 in range(0, S, cs):
            a, b, Cm = _mamba1_abc(p, x_conv[:, c0:c0 + cs])
            h, state = _solve_chunk(a, b, state)              # (B,cs,di,N)
            ys.append(torch.einsum("bsdn,bsn->bsd", h, Cm))
        y = torch.cat(ys, dim=1)

    y = y + p["D"] * x_conv.float()
    y = y * F.silu(z.float())
    out = mm("bse,ed->bsd", y, p["out_proj"], x.dtype)
    return out, {"ssm": state, "conv": new_conv}


# --------------------------------------------------------------------------
# Mamba-2 (zamba2): scalar decay per head, state (B, nh, hd, N)
# --------------------------------------------------------------------------

def _ab(A, dt_c, xh_c, B_c):
    a = torch.exp(dt_c * A)[..., None, None]                  # (B,cs,nh,1,1)
    b = (dt_c[..., None] * xh_c.float())[..., None] \
        * B_c[:, :, None, None, :].float()                    # (B,cs,nh,hd,N)
    return a, b


def _step_scan(A, state, dt_c, xh_c, B_c, C_c):
    a, b = _ab(A, dt_c, xh_c, B_c)
    h, state = _solve_chunk(a, b, state)                       # (B,cs,nh,hd,N)
    return state, torch.einsum("bshdn,bsn->bshd", h, C_c.float())


def _step_ssd(A, state, dt_c, xh_c, B_c, C_c):
    """The SSD quadratic form: intra-chunk outputs by (cs x cs) products;
    the (B,cs,nh,hd,N) discretised tensor is never materialised."""
    cs = dt_c.shape[1]
    dt32, xh32 = dt_c.float(), xh_c.float()
    Bf, Cf = B_c.float(), C_c.float()
    la = torch.cumsum(dt32 * A, dim=1)                         # log-decay
    cb = torch.einsum("btn,bsn->bts", Cf, Bf)
    ddec = la[:, :, None, :] - la[:, None, :, :]               # (B,t,s,nh)
    causal = torch.tril(torch.ones((cs, cs), dtype=torch.bool,
                                   device=dt_c.device))
    w = torch.where(causal[None, :, :, None],
                    torch.exp(torch.clamp(ddec, max=0.0)), 0.0)
    scores = cb[..., None] * w * dt32[:, None, :, :]           # (B,t,s,nh)
    y_intra = torch.einsum("btsh,bshd->bthd", scores, xh32)
    # the carried-in state read through C_t with decay e^{la_t}
    y_inter = torch.einsum("btn,bhdn,bth->bthd", Cf, state, torch.exp(la))
    # the state: decay to the chunk's end plus decayed outer products
    w_end = torch.exp(la[:, -1:, :] - la) * dt32               # (B,cs,nh)
    new_state = torch.exp(la[:, -1])[:, :, None, None] * state \
        + torch.einsum("bsh,bshd,bsn->bhdn", w_end, xh32, Bf)
    return new_state, y_intra + y_inter


def mamba2(p, x, cfg, cache=None, chunk=64):
    """x: (B, S, d) -> (B, S, d).  cache: {"ssm", "conv": {x, B, C}}.
    Returns (out, new cache)."""
    B, S, d = x.shape
    di = cfg.d_inner
    hd = cfg.ssm_head_dim
    nh = di // hd
    cd = compute_dtype()

    def proj(w):
        return mm("bsd,de->bse", x, w, cd)

    z, x_raw, B_raw, C_raw, dt_in = (proj(p["in_z"]), proj(p["in_x"]),
                                     proj(p["in_B"]), proj(p["in_C"]),
                                     proj(p["in_dt"]))
    prev = cache["conv"] if cache is not None else None
    # the depthwise conv is per channel: each component on its own
    x_in, ncx = causal_conv(x_raw, p["conv_x"], prev and prev["x"])
    Bm, ncb = causal_conv(B_raw, p["conv_B"], prev and prev["B"])
    Cm, ncc = causal_conv(C_raw, p["conv_C"], prev and prev["C"])
    dt = F.softplus(dt_in.float() + p["dt_bias"])              # (B,S,nh)
    A = -torch.exp(p["A_log"])                                 # (nh,)
    xh = x_in.reshape(B, S, nh, hd)
    state = cache["ssm"] if cache is not None else torch.zeros(
        (B, nh, hd, cfg.ssm_state), dtype=torch.float32, device=x.device)

    if S == 1:
        a, b = _ab(A, dt, xh, Bm)
        state = a[:, 0] * state + b[:, 0]
        y = torch.einsum("bhdn,bn->bhd", state, Cm[:, 0].float())[:, None]
    else:
        cs = _largest_divisor(S, chunk)
        step = _step_ssd if mamba2_impl() == "ssd" else _step_scan
        ys = []
        for c0 in range(0, S, cs):
            sl = slice(c0, c0 + cs)
            state, yc = step(A, state, dt[:, sl], xh[:, sl], Bm[:, sl],
                             Cm[:, sl])
            ys.append(yc)
        y = torch.cat(ys, dim=1)

    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, di)
    # gated RMSNorm (mamba2 standard)
    y = y * F.silu(z.float())
    var = (y * y).mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]
    out = mm("bse,ed->bsd", y, p["out_proj"], x.dtype)
    return out, {"ssm": state, "conv": {"x": ncx, "B": ncb, "C": ncc}}
