"""Synthetic regression streams (numpy only; own copy of the reference's
``piecewise_target`` / ``piecewise_regression``).

The same ``(n, n_features, seed, noise)`` gives the same arrays as the JAX
package's generator, so both packages can learn one stream.
"""
from __future__ import annotations

import numpy as np

__all__ = ["piecewise_target", "piecewise_regression"]


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
