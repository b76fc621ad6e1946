"""Robust incremental (weighted) mean/variance algebra — paper §3.

Welford's update (Eqs. 2-3), the Chan et al. parallel merge (Eqs. 4-5)
and the paper's subtraction of partial estimates (Eqs. 6-7) over a
``{"n", "mean", "m2"}`` dict of tensors.  Every function keeps the JAX
package's operation order, so merge and subtract are bitwise equal to
the reference wherever the arithmetic is exact.
"""
from __future__ import annotations

from typing import Dict

import torch

Stats = Dict[str, torch.Tensor]  # {"n": f32, "mean": f32, "m2": f32}

__all__ = ["init", "observe", "merge", "subtract", "variance", "stddev",
           "from_batch", "tree_reduce_merge"]


def init(shape=(), device=None, dtype=torch.float32) -> Stats:
    """Empty statistics (n=0). Identity element of :func:`merge`."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in ("n", "mean", "m2")}


def observe(s: Stats, y, w=1.0) -> Stats:
    """Welford single-observation update (paper Eqs. 2-3), weighted."""
    n = s["n"] + w
    safe_n = torch.where(n > 0, n, 1.0)
    d_pre = y - s["mean"]
    mean = s["mean"] + w * d_pre / safe_n
    m2 = s["m2"] + w * d_pre * (y - mean)
    return {"n": n, "mean": mean, "m2": m2}


def merge(a: Stats, b: Stats) -> Stats:
    """Chan et al. parallel merge (paper Eqs. 4-5); handles empty operands."""
    n = a["n"] + b["n"]
    safe_n = torch.where(n > 0, n, 1.0)
    delta = b["mean"] - a["mean"]
    mean = (a["n"] * a["mean"] + b["n"] * b["mean"]) / safe_n
    m2 = a["m2"] + b["m2"] + delta * delta * (a["n"] * b["n"]) / safe_n
    # keep the identity exact when both sides are empty
    mean = torch.where(n > 0, mean, 0.0)
    m2 = torch.where(n > 0, m2, 0.0)
    return {"n": n, "mean": mean, "m2": m2}


def subtract(ab: Stats, b: Stats) -> Stats:
    """Paper Eqs. 6-7: recover A = AB - B from whole and partial stats."""
    n_a = ab["n"] - b["n"]
    safe_na = torch.where(n_a > 0, n_a, 1.0)
    mean_a = (ab["n"] * ab["mean"] - b["n"] * b["mean"]) / safe_na
    delta = b["mean"] - mean_a
    safe_nab = torch.where(ab["n"] > 0, ab["n"], 1.0)
    m2_a = ab["m2"] - b["m2"] - delta * delta * (n_a * b["n"]) / safe_nab
    mean_a = torch.where(n_a > 0, mean_a, 0.0)
    # numerical floor: M2 is a sum of squares, clamp tiny negatives
    m2_a = torch.where(n_a > 0, torch.clamp(m2_a, min=0.0), 0.0)
    return {"n": n_a, "mean": mean_a, "m2": m2_a}


def variance(s: Stats, ddof: int = 1) -> torch.Tensor:
    """Sample variance s^2 = M2/(n-ddof); 0 where undefined (n<=ddof)."""
    denom = s["n"] - ddof
    return torch.where(denom > 0,
                       s["m2"] / torch.where(denom > 0, denom, 1.0), 0.0)


def stddev(s: Stats, ddof: int = 1) -> torch.Tensor:
    return torch.sqrt(torch.clamp(variance(s, ddof), min=0.0))


def tree_reduce_merge(s: Stats, dim: int = 0) -> Stats:
    """Reduce a stacked Stats along ``dim`` with the Chan merge, in the
    reference's log-depth pairwise order (halves merged, an odd tail
    carried to the next level)."""
    s = {k: torch.movedim(v, dim, 0) for k, v in s.items()}
    while s["n"].shape[0] > 1:
        k = s["n"].shape[0]
        half = k // 2
        m = merge({kk: v[:half] for kk, v in s.items()},
                  {kk: v[half:2 * half] for kk, v in s.items()})
        if k % 2:
            m = {kk: torch.cat([v, s[kk][-1:]], 0) for kk, v in m.items()}
        s = m
    return {k: v[0] for k, v in s.items()}


def from_batch(y: torch.Tensor, w=None, dim: int = 0) -> Stats:
    """Exact two-pass batch statistics along ``dim``."""
    if w is None:
        mean = y.mean(dim=dim)
        n = torch.full_like(mean, float(y.shape[dim]))
        m2 = ((y - mean.unsqueeze(dim)) ** 2).sum(dim=dim)
        return {"n": n, "mean": mean, "m2": m2}
    n = w.sum(dim=dim)
    safe_n = torch.where(n > 0, n, 1.0)
    mean = (w * y).sum(dim=dim) / safe_n
    m2 = (w * (y - mean.unsqueeze(dim)) ** 2).sum(dim=dim)
    mean = torch.where(n > 0, mean, 0.0)
    return {"n": n, "mean": mean, "m2": m2}
