"""Synthetic streams (numpy only; own copies of the reference's
``data/synth.py``).

* the paper's §5.1 protocol (Table 1) for one monitored feature:
  :data:`SAMPLE_SIZES`, :data:`DISTRIBUTIONS`, :class:`SynthConfig`,
  :func:`sample_x` and :func:`generate` -- three distributions with three
  parameterizations each, a linear or cubic target, noise on a fraction
  of the instances;
* the multivariate piecewise stream the tree and forest learn
  (:func:`piecewise_target`, :func:`piecewise_regression`).

The same arguments give the same arrays as the JAX package's generators,
so both packages can learn one stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["SAMPLE_SIZES", "DISTRIBUTIONS", "TASKS", "SynthConfig",
           "sample_x", "generate", "piecewise_target",
           "piecewise_regression"]

SAMPLE_SIZES = [50, 100, 200, 400, 500, 750, 1000, 2500, 5000, 7000, 10000,
                15000, 25000, 50000, 75000, 100000, 200000, 500000, 1000000]

DISTRIBUTIONS = {
    # name -> list of parameterizations
    "normal": [(0.0, 1.0), (0.0, 0.1), (0.0, 7.0)],
    "uniform": [(-1.0, 1.0), (-0.1, 0.1), (-7.0, 7.0)],
    "bimodal": [((-1.0, 1.0), (1.0, 1.0)),
                ((-0.1, 0.1), (0.1, 0.1)),
                ((-7.0, 7.0), (7.0, 0.1))],   # asymmetric third variant
}

TASKS = ("lin", "cub")


@dataclass(frozen=True)
class SynthConfig:
    dist: str = "normal"     # normal | uniform | bimodal
    variant: int = 0         # parameterization index (0..2)
    task: str = "lin"        # lin | cub
    noise_frac: float = 0.0  # 0.0 or 0.1 (paper)
    n: int = 10000
    seed: int = 0


def sample_x(cfg: SynthConfig, rng: np.random.Generator) -> np.ndarray:
    p = DISTRIBUTIONS[cfg.dist][cfg.variant]
    if cfg.dist == "normal":
        return rng.normal(p[0], p[1], cfg.n).astype(np.float32)
    if cfg.dist == "uniform":
        return rng.uniform(p[0], p[1], cfg.n).astype(np.float32)
    # bimodal: equal-probability mixture of two normals
    (m1, s1), (m2, s2) = p
    pick = rng.random(cfg.n) < 0.5
    a = rng.normal(m1, s1, cfg.n)
    b = rng.normal(m2, s2, cfg.n)
    return np.where(pick, a, b).astype(np.float32)


def generate(cfg: SynthConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) float32 arrays of length ``cfg.n``; the target's random
    coefficients are re-drawn per seed."""
    rng = np.random.default_rng(cfg.seed)
    x = sample_x(cfg, rng)
    if cfg.task == "lin":
        a, b = rng.normal(0, 1, 2)
        y = a * x + b
    elif cfg.task == "cub":
        a, b, c, d = rng.normal(0, 1, 4)
        y = a * x ** 3 + b * x ** 2 + c * x + d
    else:
        raise ValueError(cfg.task)
    if cfg.noise_frac > 0:
        # sigma matched to the dispersion of the generating distribution
        scale = 0.01 if cfg.variant == 1 else 0.1
        mask = rng.random(cfg.n) < cfg.noise_frac
        y = y + mask * rng.normal(0, scale, cfg.n)
    return x.astype(np.float32), y.astype(np.float32)


def piecewise_target(X: np.ndarray, shift=0.0) -> np.ndarray:
    """The shared piecewise-constant tree target; ``shift`` moves the root
    split point (the concept-drift knob)."""
    F = X.shape[1]
    return np.where(X[:, 0] <= shift,
                    np.where(X[:, 1 % F] <= 0.5, 1.0, 5.0),
                    np.where(X[:, 2 % F] <= -0.2, 9.0, 13.0))


def piecewise_regression(n: int, n_features: int = 4, seed: int = 0,
                         noise: float = 0.1):
    """(X, y) float32: ``n`` rows of ``n_features`` standard normals and the
    piecewise target plus gaussian noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, n_features)).astype(np.float32)
    y = (piecewise_target(X) + noise * rng.normal(0, 1, n)).astype(np.float32)
    return X, y
