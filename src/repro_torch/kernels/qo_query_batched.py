"""QO split query over the attempting (leaf, feature) tables.

Replaces ``src/repro/kernels/qo_query_batched.py::qo_query_batched_pallas``
and the per-table argmax epilogue of ``ops._query_full``.  For each of the
K gathered table rows and each feature: the variance reduction (VR) of
every boundary between occupied bins, the candidate threshold at the
midpoint of the neighbouring occupied prototypes, and the best boundary
(``jnp.argmax`` order: a NaN wins, then the first maximum).  Returns
(merit, thr), both (K, F); merit is -inf and thr 0 where a table has no
valid boundary.

:func:`best_splits` launches ``csrc/qo_query_batched.cu`` (a warp per
table: the TPU kernel's Kogge-Stone prefix Chan merge over chunks of 32
bins, or 16 for C <= 16) on a CUDA tensor and runs
:func:`best_splits_plain` (the reference's ``ops._forest_query_jnp``:
centred prefix sums) on a CPU one.  The two differ by f32 rounding only
(ROADMAP B3, C6).  ``warps`` (the most warps a block) is the launch's
schedule knob: :data:`WARPS_CHOICES` are compiled, a warp owns its tables
alone so every one gives the same bits, and the plain version never sees
it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["query_scores_plain", "best_splits_plain", "best_splits_kernel",
           "best_splits", "cost", "MAX_BINS", "WARPS", "WARPS_CHOICES"]

#: Largest C the kernel takes: a table's chunk entries (5 floats per 32
#: bins) in one block's 48 KB of shared memory.
MAX_BINS = 65536
#: The most warps a block by default (fewer where C is large: a block's
#: chunk entries stay within 48 KB), and the values compiled.
WARPS = 4
WARPS_CHOICES = (1, 2, 4, 8)


def cost(K: int, F: int, C: int):
    """``(bytes, flops)`` of a query of K table rows: the four planes of
    the K*F tables read once, the row ids, the (K, F) merits and
    thresholds written; about 30 flops a bin."""
    return K * F * C * 16 + K * 4 + K * F * 8, K * F * C * 30


def query_scores_plain(n, mean, m2, sum_x):
    """Per-boundary (score, cand), both (R, C), for R = K*F tables of C
    bins: the reference's centred prefix-sum lowering, op for op."""
    R, C = n.shape
    dev = n.device
    occ = n > 0
    # VR is shift-invariant: centre bin means on each table's grand mean
    n_tab = n.sum(-1, keepdim=True)
    grand = (n * mean).sum(-1, keepdim=True) / torch.clamp(n_tab, min=1.0)
    mu = mean - grand
    sy = n * mu
    sq = m2 + sy * mu
    pref = torch.cumsum(torch.stack([n, sy, sq], 0), dim=-1)   # (3, R, C)
    Nl, SYl, SQl = pref[0], pref[1], pref[2]
    Nt, SYt, SQt = Nl[:, -1:], SYl[:, -1:], SQl[:, -1:]
    Nr, SYr, SQr = Nt - Nl, SYt - SYl, SQt - SQl

    def var(NN, SY, SQ):
        d = NN - 1.0
        m2_ = torch.clamp(SQ - SY * SY / torch.where(NN > 0, NN, 1.0),
                          min=0.0)
        return torch.where(d > 0, m2_ / torch.where(d > 0, d, 1.0), 0.0)

    s2d = var(Nt, SYt, SQt)
    ntot = torch.clamp(Nt, min=1.0)
    vr = s2d - (Nl / ntot) * var(Nl, SYl, SQl) \
        - (Nr / ntot) * var(Nr, SYr, SQr)

    idx = torch.arange(C, device=dev).expand(R, C)
    last = torch.cummax(torch.where(occ, idx, -1), dim=1).values
    first_after = torch.flip(torch.cummin(
        torch.flip(torch.where(occ, idx, C), [1]), dim=1).values, [1])
    nxt = torch.cat([first_after[:, 1:],
                     torch.full((R, 1), C, dtype=idx.dtype, device=dev)], 1)
    ok = (last >= 0) & (nxt < C)
    proto = torch.where(occ, sum_x / torch.where(occ, n, 1.0), 0.0)
    p_l = torch.gather(proto, 1, torch.clamp(last, min=0))
    p_r = torch.gather(proto, 1, torch.clamp(nxt, max=C - 1))
    cand = 0.5 * (p_l + p_r)
    score = torch.where(ok, vr, float("-inf"))
    return score, cand


def best_splits_plain(tab_y, tab_sum_x, rows):
    """Plain PyTorch query of the table rows ``rows`` -> (merit, thr)."""
    _, F, C = tab_sum_x.shape
    K = rows.shape[0]
    rows = rows.long()
    flat = lambda a: a[rows].reshape(K * F, C)
    score, cand = query_scores_plain(flat(tab_y["n"]), flat(tab_y["mean"]),
                                     flat(tab_y["m2"]), flat(tab_sum_x))
    best = torch.argmax(score, -1)
    merit = torch.amax(score, -1)
    thr = torch.gather(cand, 1, best[:, None])[:, 0]
    thr = torch.where(merit == float("-inf"), 0.0, thr)
    return merit.reshape(K, F), thr.reshape(K, F)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_query_batched").qo_query_batched_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def best_splits_kernel(tab_y, tab_sum_x, rows, warps: int = WARPS):
    """Launch ``csrc/qo_query_batched.cu`` over the K table rows ``rows``,
    at most ``warps`` warps a block.  K = 0 launches nothing."""
    warps = _build.check_knob("qo_query_batched", "warps", warps,
                              WARPS_CHOICES)
    N, F, C = tab_sum_x.shape
    dev = tab_sum_x.device
    for name, t in (("n", tab_y["n"]), ("mean", tab_y["mean"]),
                    ("m2", tab_y["m2"]), ("sum_x", tab_sum_x)):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != (N, F, C):
            raise ValueError(f"qo_query_batched: {name} must be a contiguous "
                             f"float32 (N, F, C) tensor on {dev}")
    if rows.device != dev or rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError(f"qo_query_batched: rows must be int32 (K,) on {dev}")
    if not 0 < C <= MAX_BINS:
        raise ValueError(f"qo_query_batched: C = {C}, expected "
                         f"1..{MAX_BINS}")
    K = rows.shape[0]
    merit = torch.empty((K, F), dtype=torch.float32, device=dev)
    thr = torch.empty((K, F), dtype=torch.float32, device=dev)
    if K == 0:
        return merit, thr
    rows = rows.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(rows.data_ptr(), tab_y["n"].data_ptr(),
                     tab_y["mean"].data_ptr(), tab_y["m2"].data_ptr(),
                     tab_sum_x.data_ptr(), merit.data_ptr(), thr.data_ptr(),
                     K, F, C, warps, stream)
    _build.check(rc, "qo_query_batched")
    _build.launched("qo_query_batched", lambda: cost(K, F, C))
    return merit, thr


def best_splits(tab_y, tab_sum_x, rows, warps: int = WARPS):
    """The plain version on a CPU tensor, else the kernel (or a raise).
    ``warps`` is checked on both: the plain version never sees it."""
    if tab_sum_x.device.type == "cpu":
        _build.check_knob("qo_query_batched", "warps", warps, WARPS_CHOICES)
        return best_splits_plain(tab_y, tab_sum_x, rows)
    return best_splits_kernel(tab_y, tab_sum_x, rows, warps)
