#!/usr/bin/env python3
"""The JAX reference's QO merit ratios on the streams of ``chip_smoke.py``
phase 14, on the CPU: the yardstick for the port's numbers there.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools_torch/aos_reference.py [--n N] [--seed S]

For each of the 18 §5.1 streams (noise 0.1, ``n`` rows, the seed of
``chip_smoke.py``) prints the ratio of the reference's ``qo.best_split``
merit to the exhaustive best split (float64) for the three QO variants
of ``benchmarks/aos.py`` (r = 0.01, sigma/2, sigma/3), and the targets'
kappa^2 = 1 + mean^2 / var, which bounds how finely f32 statistics
resolve a merit.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.aos import QO_VARIANTS, _make_qo  # noqa: E402
from repro.core import qo  # noqa: E402
from repro.data import synth  # noqa: E402


def exact_merit(x, y):
    """The exhaustive best split's VR, float64, vectorized."""
    o = np.argsort(x, kind="stable")
    xs, ys = x[o].astype(np.float64), y[o].astype(np.float64)
    n = ys.shape[0]
    cs, cq = np.cumsum(ys), np.cumsum(ys * ys)
    nl = np.arange(1, n, dtype=np.float64)
    nr = n - nl
    sl, ql = cs[:-1], cq[:-1]
    sr, qr = cs[-1] - sl, cq[-1] - ql
    vl = np.where(nl > 1, (ql - sl * sl / nl) / np.maximum(nl - 1, 1), 0.0)
    vr = np.where(nr > 1, (qr - sr * sr / nr) / np.maximum(nr - 1, 1), 0.0)
    m = np.var(ys, ddof=1) - nl / n * vl - nr / n * vr
    return float(np.where(xs[:-1] < xs[1:], m, -np.inf).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    update, best = jax.jit(qo.update), jax.jit(qo.best_split)
    print("stream kappa^2 " + " ".join(QO_VARIANTS))
    for dist in synth.DISTRIBUTIONS:
        for v in range(3):
            for task in synth.TASKS:
                x, y = synth.generate(synth.SynthConfig(dist, v, task, 0.1,
                                                        args.n, args.seed))
                exact = exact_merit(x, y)
                ratios = [float(best(update(_make_qo(name, x),
                                            jnp.asarray(x),
                                            jnp.asarray(y))).merit) / exact
                          for name in QO_VARIANTS]
                y64 = y.astype(np.float64)
                kappa2 = 1.0 + y64.mean() ** 2 / y64.var(ddof=1)
                print(f"{dist}/{v}/{task} {kappa2:.1f} "
                      + " ".join(f"{r:.4f}" for r in ratios), flush=True)


if __name__ == "__main__":
    main()
