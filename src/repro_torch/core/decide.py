"""Split-decision backends: fixed-n Hoeffding ratio test vs anytime-valid
e-process (the reference's ``core/decide.py``, DESIGN.md §2.7).

Every function works on a leading batch of trees: merit is (..., M, F),
the state's leaves are (..., M) / (..., M, F), so one call decides for a
whole forest (the reference vmaps the single-tree version).  Constants
and operation order follow the reference; logarithms are taken in f32 as
XLA takes them.
"""
from __future__ import annotations

import torch

from repro_torch.core import stats

__all__ = ["DECISION_BACKENDS", "DECISION_KEYS", "decision_state",
           "sanitize_merit", "decide", "E_LAMBDA", "E_SEL", "E_MARGIN"]

DECISION_BACKENDS = ("hoeffding", "anytime")
DECISION_KEYS = ("dec_logE", "dec_n_last")

E_LAMBDA = 0.3   # betting fraction of the e-process
E_SEL = 2.0      # selection-correction multiplier of the null mean
E_MARGIN = 0.01  # practical-null floor on the explained-variance fraction


def decision_state(M: int, F: int, device) -> dict:
    """Fresh decision leaves: ``dec_logE`` (M, F), ``dec_n_last`` (M,)."""
    return {"dec_logE": torch.zeros((M, F), dtype=torch.float32,
                                    device=device),
            "dec_n_last": torch.zeros((M,), dtype=torch.float32,
                                      device=device)}


def _f32_log(v: float, device) -> torch.Tensor:
    return torch.log(torch.tensor(v, dtype=torch.float32, device=device))


def sanitize_merit(merit, feat_mask=None):
    """NaN merits -> -inf; features outside the (..., F) subspace mask ->
    -inf."""
    merit = torch.where(torch.isnan(merit), float("-inf"), merit)
    if feat_mask is not None:
        merit = torch.where(feat_mask[..., None, :], merit, float("-inf"))
    return merit


def _hoeffding_want(cfg, state, merit, attempt):
    """The FIMT ratio test plus the ``n_finite >= 2`` degenerate-leaf
    guard."""
    top2 = torch.topk(merit, 2, dim=-1).values
    vr1, vr2 = top2[..., 0], top2[..., 1]
    n_leaf = torch.clamp(state["ystats"]["n"], min=1.0)
    eps = torch.sqrt(_f32_log(1.0 / cfg.delta, merit.device) / (2.0 * n_leaf))
    ratio = torch.where(vr1 > 0, torch.clamp(vr2, min=0.0) / vr1, 1.0)
    decide_ = (ratio < 1.0 - eps) | (eps < cfg.tau)
    n_finite = torch.isfinite(merit).sum(-1)
    want = attempt & decide_ & torch.isfinite(vr1) & (vr1 > 0) \
        & (n_finite >= 2)
    return want, {}


def _anytime_want(cfg, state, merit, attempt):
    """Per-(leaf, feature) e-process update + threshold crossing."""
    dev = merit.device
    finite = torch.isfinite(merit)
    n_leaf = state["ystats"]["n"]
    sigma2 = torch.clamp(stats.variance(state["ystats"]), min=1e-12)
    eta = torch.clamp(torch.where(finite, merit, 0.0) / sigma2[..., None],
                      0.0, 1.0)
    safe_n = torch.clamp(n_leaf, min=1.0)
    # C is the observer's slot count: a K-slot sketch offers fewer
    # candidate boundaries than n_bins dense bins
    log_fc = _f32_log(float(max(cfg.n_features, 2) * cfg.observer_bins()),
                      dev)
    mu0 = E_MARGIN + E_SEL * log_fc / safe_n
    dn = torch.clamp(n_leaf - state["dec_n_last"], min=0.0)
    inc = dn[..., None] * (E_LAMBDA * (eta - mu0[..., None])
                           - E_LAMBDA * E_LAMBDA / 8.0)
    logE = torch.clamp(state["dec_logE"] + torch.where(finite, inc, 0.0),
                       min=0.0)
    logE = torch.where(attempt[..., None], logE, state["dec_logE"])
    n_last = torch.where(attempt, n_leaf, state["dec_n_last"])

    best_f = torch.argmax(merit, dim=-1)
    vr1 = torch.gather(merit, -1, best_f[..., None])[..., 0]
    crossed = torch.gather(logE, -1, best_f[..., None])[..., 0] \
        >= _f32_log(1.0 / cfg.alpha, dev)
    want = attempt & crossed & torch.isfinite(vr1) & (vr1 > 0)
    return want, {"dec_logE": logE, "dec_n_last": n_last}


def decide(cfg, state, merit, attempt, feat_mask=None):
    """Which attempting leaves split, on which feature.

    Returns ``(want, best_f, dec_new)``: (..., M) bool, the (..., M) int64
    merit champion per leaf, and the updated decision leaves (empty under
    ``"hoeffding"``)."""
    merit = sanitize_merit(merit, feat_mask)
    best_f = torch.argmax(merit, dim=-1)
    if cfg.decision_backend == "hoeffding":
        want, dec_new = _hoeffding_want(cfg, state, merit, attempt)
    else:
        want, dec_new = _anytime_want(cfg, state, merit, attempt)
    return want, best_f, dec_new
