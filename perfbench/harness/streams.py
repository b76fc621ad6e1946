"""The one traffic generator: every traffic mix is a data file of
parameters (``traffic/<name>.json``) that this module reads.

Streams (``"stream"``):

* ``friedman1``: Friedman's #1 regression problem (Friedman 1991; scikit-
  learn's ``make_friedman1``): x ~ U(0, 1)^F and
  y = 10 sin(pi x1 x2) + 20 (x3 - 1/2)^2 + 10 x4 + 5 x5 + noise_sd N(0, 1).

Drift (``"drift"``): ``none``, or ``gra``, global recurring abrupt drift
(Ikonomovska et al. 2011; River's ``FriedmanDrift(drift_type="gra")``):
the five relevant features move from x1..x5 to x6..x10 and back every
``period_batches`` batches.

Feature map (``"feature_map"``): ``identity``, or ``cauchy``, every
feature passed through the Cauchy quantile map tan(pi (x - 1/2)) after y
is drawn (monotone, so the planted structure survives; heavy-tailed).

Everything is drawn on the device from one ``torch.Generator`` seeded with
the run's seed, in a few large calls, in a fixed order.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def friedman1(x, concept, noise):
    """y of Friedman #1 on rows x (..., F), the relevant features starting
    at column 5 * concept (concept broadcasts over the leading axes)."""
    s = (5 * concept)[..., None].expand(x.shape[:-1] + (5,)) \
        + torch.arange(5, device=x.device)
    r = torch.gather(x, -1, s)
    return (10.0 * torch.sin(math.pi * r[..., 0] * r[..., 1])
            + 20.0 * (r[..., 2] - 0.5) ** 2 + 10.0 * r[..., 3] + 5.0 * r[..., 4]
            + noise)


def feature_map(x, name):
    if name == "identity":
        return x
    if name == "cauchy":
        # in float64: at x = 0 a float32 pi/2 would step past the pole
        return torch.tan(math.pi * (x.double() - 0.5)).float()
    raise ValueError(f"unknown feature map {name!r}")


def concepts(traffic, n_batches, device):
    """(n_batches,) concept index of each batch of the pool."""
    idx = torch.arange(n_batches, device=device)
    if traffic["drift"] == "none":
        return torch.zeros_like(idx)
    if traffic["drift"] == "gra":
        return (idx // traffic["period_batches"]) % 2
    raise ValueError(f"unknown drift {traffic['drift']!r}")


def subspace_k(cfg):
    return max(1, int(round(cfg["subspace"] * cfg["n_features"])))


def learn_pool(cfg, traffic, seed, device, n_batches=None):
    """The pool a learn cell cycles: ``X`` (P, B, F), ``y`` (P, B), the
    bagging weights ``bag_w`` (P, T, B) ~ Poisson(lam), the subspace
    masks ``masks`` (P, T, F) a swapped member gets, and ``mask0`` (T, F),
    the forest's first masks."""
    P = traffic["pool_batches"] if n_batches is None else n_batches
    B, F, T = cfg["batch_rows"], cfg["n_features"], cfg["n_trees"]
    g = generator(seed, device)
    x = torch.rand((P, B, F), generator=g, device=device)
    noise = traffic["noise_sd"] * torch.randn((P, B), generator=g, device=device)
    y = friedman1(x, concepts(traffic, P, device)[:, None], noise)
    X = feature_map(x, traffic["feature_map"])
    del x
    bag_w = torch.poisson(torch.full((P, T, B), float(cfg["lam"]), device=device),
                          generator=g)
    perm = torch.argsort(torch.rand((P + 1, T, F), generator=g, device=device), -1)
    masks = torch.zeros((P + 1, T, F), dtype=torch.bool, device=device)
    masks.scatter_(-1, perm[..., :subspace_k(cfg)], True)
    return {"X": X.contiguous(), "y": y.contiguous(), "bag_w": bag_w.contiguous(),
            "masks": masks[1:].contiguous(), "mask0": masks[0].contiguous()}


def request_rows(traffic, seed):
    """(L,) request sizes: L log-uniform quantiles over [min, max] rows,
    the same multiset for every seed, in an order drawn from the seed."""
    L = traffic["sizes"]
    lo, hi = math.log(traffic["request_rows_min"]), math.log(traffic["request_rows_max"])
    q = (np.arange(L) + 0.5) / L
    rows = np.clip(np.rint(np.exp(lo + (hi - lo) * q)), traffic["request_rows_min"],
                   traffic["request_rows_max"]).astype(np.int64)
    return np.random.default_rng(int(seed)).permutation(rows)


def request_pool(cfg, traffic, seed, device):
    """(pool_rows, F) float32 host rows that requests are cut from, drawn
    on the device (after the learn pool's draws) and copied once."""
    g = generator(int(seed) + 1, device)
    x = torch.rand((traffic["pool_rows"], cfg["n_features"]), generator=g, device=device)
    return feature_map(x, traffic["feature_map"]).cpu().numpy()
