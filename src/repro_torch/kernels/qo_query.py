"""Single-table QO split query (paper Algorithm 2), argmax fused.

Replaces ``src/repro/kernels/qo_query.py::qo_query_pallas`` and the
argmax epilogue of ``ops.qo_best_split``.  For a table of C bins
(``n``, ``mean``, ``m2``, ``sum_x`` planes) it computes, at every bin i:

* the inclusive prefix Chan merge (the left side), the complement by the
  paper's subtraction (Eqs. 6-7) and the variance reduction VR;
* the last occupied bin at or before i and the next occupied bin after
  it: VR counts (the ``score`` row) only where both exist, else -inf;
* the candidate threshold (the ``cand`` row) at the midpoint of those two
  bins' prototypes ``sum_x / n``;

and then the best boundary as ``jnp.argmax`` picks it (the first NaN,
else the first maximum): ``result = [threshold, merit, valid]`` with
merit 0 and valid 0 where the best score is not finite.

:func:`best` launches ``csrc/qo_query.cu`` on a CUDA tensor and runs
:func:`best_plain` (the TPU kernel's Hillis-Steele prefix merge over all
bins, op for op) on a CPU one.  The kernel skips empty bins in its merges
(the identity), so the two differ by f32 rounding only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["scores_plain", "argmax_nan_first", "best_plain", "best_kernel",
           "best", "SplitResult", "split", "MAX_BINS"]

#: The kernel keeps two (C,) rows and its scan scratch in one block's
#: shared memory: 8 C + 20 KB must stay within the 227 KB a block can use.
MAX_BINS = 16384


def _shift_right(a, d, fill):
    pad = torch.full(a.shape[:-1] + (d,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-d]], -1)


def scores_plain(n, mean, m2, sum_x):
    """(score, cand) rows, both shaped like the (..., C) planes."""
    C = n.shape[-1]
    occ = n > 0
    left = {"n": n, "mean": mean, "m2": m2}
    d = 1
    while d < C:      # Hillis-Steele inclusive prefix merge over the bins
        left = stats.merge({k: _shift_right(v, d, 0.0)
                            for k, v in left.items()}, left)
        d *= 2
    tot = {k: v[..., -1:].expand_as(v) for k, v in left.items()}
    right = stats.subtract(tot, left)
    n_tot = torch.clamp(tot["n"], min=1.0)
    vr = stats.variance(tot) - (left["n"] / n_tot) * stats.variance(left) \
        - (right["n"] / n_tot) * stats.variance(right)

    proto = torch.where(occ, sum_x / torch.where(occ, n, 1.0), 0.0)
    idx = torch.arange(C, device=n.device).expand(n.shape)
    last = torch.cummax(torch.where(occ, idx, -1), -1).values
    first_from = torch.flip(torch.cummin(
        torch.flip(torch.where(occ, idx, C), [-1]), -1).values, [-1])
    nxt = torch.cat([first_from[..., 1:],
                     torch.full(n.shape[:-1] + (1,), C, dtype=idx.dtype,
                                device=n.device)], -1)
    ok = (last >= 0) & (nxt < C)
    cand = 0.5 * (torch.gather(proto, -1, torch.clamp(last, min=0))
                  + torch.gather(proto, -1, torch.clamp(nxt, max=C - 1)))
    return torch.where(ok, vr, float("-inf")), cand


def argmax_nan_first(score):
    """``jnp.argmax`` over the last axis: the first NaN, else the first
    maximum."""
    nan = torch.isnan(score)
    first_nan = torch.argmax(nan.to(torch.int8), -1)
    first_max = torch.argmax(torch.where(nan, float("-inf"), score), -1)
    return torch.where(nan.any(-1), first_nan, first_max)


def best_plain(n, mean, m2, sum_x):
    """Plain PyTorch query of one (C,) table -> (score, cand, result)."""
    score, cand = scores_plain(n, mean, m2, sum_x)
    b = argmax_nan_first(score)
    valid = torch.isfinite(score[b])
    result = torch.stack([cand[b], torch.where(valid, score[b], 0.0),
                          valid.to(torch.float32)])
    return score, cand, result


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_query").qo_query_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def best_kernel(n, mean, m2, sum_x):
    """Launch ``csrc/qo_query.cu`` on one (C,) table -> (score, cand,
    result), result = [threshold, merit, valid] as float32."""
    dev = n.device
    C = n.shape[0]
    for name, t in (("n", n), ("mean", mean), ("m2", m2), ("sum_x", sum_x)):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != (C,):
            raise ValueError(f"qo_query: {name} must be a contiguous float32 "
                             f"(C,) tensor on {dev}")
    if not 0 < C <= MAX_BINS:
        raise ValueError(f"qo_query: C = {C} bins, expected 1..{MAX_BINS}")
    score = torch.empty(C, dtype=torch.float32, device=dev)
    cand = torch.empty(C, dtype=torch.float32, device=dev)
    result = torch.empty(3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(n.data_ptr(), mean.data_ptr(), m2.data_ptr(),
                     sum_x.data_ptr(), score.data_ptr(), cand.data_ptr(),
                     result.data_ptr(), C, stream)
    _build.check(rc, "qo_query")
    _build.LAUNCHES["qo_query"] += 1
    return score, cand, result


def best(n, mean, m2, sum_x):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if n.device.type == "cpu":
        return best_plain(n, mean, m2, sum_x)
    return best_kernel(n, mean, m2, sum_x)


class SplitResult(NamedTuple):
    threshold: torch.Tensor  # best cut point c
    merit: torch.Tensor      # VR at c (paper Eq. 1); 0 when not valid
    valid: torch.Tensor      # bool: the best score is finite


def split(n, mean, m2, sum_x) -> SplitResult:
    """The best split of one (C,) table as 0-d tensors (no host sync)."""
    _, _, r = best(n, mean, m2, sum_x)
    return SplitResult(threshold=r[0], merit=r[1], valid=r[2] > 0)
