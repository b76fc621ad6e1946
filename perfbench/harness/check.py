"""The comparison that decides ``correct``.

A learned step is judged against the plain reference
(``reference/arf.py``) run on the same batch and draws, from the
program's pre-step state (a window step) or from a forest the reference
has carried itself from an empty one (the carried comparison; it takes
over the program's float values only where they agree with its own to
rounding, :func:`adopt_rounding`).  The reference's choices (which leaves split, on which feature
and boundary, which member is swapped) are its own, except where its own
margin for a choice lies inside a rounding band: there the program's
choice is taken over, and counted as ``adopted``.  Every other
disagreement is a mismatch.  The numbers compared:

* ``route_mismatch``: rows whose leaf id differs from the reference's,
  plus leaves whose batch weight differs (both exact);
* ``choice_mismatch``: split choices (leaf, feature, boundary) and swap
  choices (drift signal, swapped member) that differ outside the band,
  plus differing entries of the integer and boolean arrays of the
  post-step state (exact);
* ``state_err``: the largest normalized gap of any float array of the
  post-step state (tables, target statistics, thresholds, grids, drift
  windows, vote weights);
* ``pred_err``: the largest relative gap of the prequential member and
  forest errors.

A served request is judged by ``serve_err``, the largest normalized gap
of its answers against the reference's vote over the live trees.
"""
from __future__ import annotations

import torch

from reference import arf

#: Rounding bands.  A split choice is taken over from the program where
#: the reference's margin is within MERIT_BAND of the leaf's target
#: variance (the query's merits are variance reductions, bounded by it);
#: a drift choice where the error average lies within DRIFT_BAND
#: (relative) of its threshold or of the runner-up's.
MERIT_BAND = 1e-4
DRIFT_BAND = 1e-4
#: Candidate thresholds within THR_BAND (relative) are the same boundary.
THR_BAND = 1e-5
#: A carried float value within ROUND_BAND of the program's (relative,
#: with a floor at the array's scale) is taken over from the program.
ROUND_BAND = 1e-5

def _norm_err(p, r):
    """max |p - r| / (|r| + s), s the mean |r| over r's non-zero entries
    (1e-30 if none): a relative gap with a floor at the array's scale."""
    p, r = p.double().reshape(-1), r.double().reshape(-1)
    fin = torch.isfinite(r)
    if not torch.equal(torch.isfinite(p), fin) or not torch.equal(p[~fin], r[~fin]):
        return float("inf")
    p, r = p[fin], r[fin]
    if r.numel() == 0:
        return 0.0
    nz = r != 0
    s = float(r.abs()[nz].mean()) if bool(nz.any()) else 1e-30
    return float(((p - r).abs() / (r.abs() + s)).max())


def _flat(state):
    """Name -> tensor of every array of a forest state."""
    out = {}
    for k, v in state["trees"].items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    for k in ("err_win",):
        out.update({f"{k}.{kk}": vv for kk, vv in state[k].items()})
    for k in ("err_ewma", "vote_w", "feat_mask", "resets"):
        out[k] = state[k]
    return out


def _reconcile_drift(pre_prog, post_prog, prep, mine, drift_p):
    """The swap choice to apply and the number of members that disagree
    outside the band."""
    ewma, bar = prep["ewma"].double(), prep["drift_bar"].double()
    scale = ewma.abs() + bar.abs() + 1e-30
    amb_sig = (ewma - bar).abs() <= DRIFT_BAND * scale
    frozen = torch.ones_like(drift_p)
    for k in ("n", "mean", "m2"):
        frozen &= post_prog["err_win"][k] == pre_prog["err_win"][k]
    sig_p = (frozen & prep["drift_ready"]) | drift_p
    signal = torch.where(amb_sig, sig_p, mine["signal"])
    mism = int(((sig_p != mine["signal"]) & ~amb_sig & ~drift_p).sum())
    masked = torch.where(signal, ewma, torch.full_like(ewma, float("-inf")))
    worst = int(torch.argmax(masked))
    drift = signal & (torch.arange(signal.shape[0], device=signal.device) == worst)
    if not torch.equal(drift, drift_p):
        top = torch.topk(masked, min(2, masked.numel())).values
        tie = top.numel() == 2 and bool(torch.isfinite(top).all()) \
            and float(top[0] - top[1]) <= DRIFT_BAND * float(top[0].abs() + 1e-30)
        amb = tie | bool(amb_sig[drift ^ drift_p].any())
        if amb:
            drift = drift_p.clone()
            signal = signal | drift
        else:
            mism += int((drift != drift_p).sum())
    return signal, drift, mism


def _reconcile_splits(pre_prog, post_prog, prep, mine, drift):
    """The split choices to apply, the number of leaves that disagree
    outside the band and the number taken over."""
    want = mine["want"].clone()
    best_f = mine["best_f"].clone()
    best_c = mine["best_c"].clone()
    keep = ~drift[:, None]                           # members not swapped
    split_p = pre_prog["trees"]["is_leaf"] & ~post_prog["trees"]["is_leaf"] & keep
    attempt = prep["attempt"]
    M = attempt.shape[1]
    mism = int((split_p & ~attempt).sum())
    var = arf.variance(prep["learned"]["ystats"]).double()
    band = MERIT_BAND * torch.clamp(var, min=1e-30)
    vr1, vr2 = mine["vr1"].double(), mine["vr2"].double()
    eps = mine["eps"].double()
    amb_want = ((vr2.clamp(min=0) - (1.0 - eps) * vr1).abs() <= 2 * band) \
        | (vr1.abs() <= band)
    # the program's split set is want & capacity: compare it there
    k = torch.cumsum(want.to(torch.int32), -1) - 1
    can = want & (pre_prog["trees"]["n_nodes"][:, None] + 2 * k + 1 < M)
    diff = (can != split_p) & attempt & keep
    adopted = int((diff & amb_want).sum())
    mism += int((diff & ~amb_want).sum())
    want = torch.where(diff & amb_want, split_p, want)
    both = split_p & want & attempt
    if bool(both.any()):
        f_p = post_prog["trees"]["feature"].long()
        c_p = post_prog["trees"]["threshold"]
        merit = mine["merit"].double()
        m_best = torch.gather(merit, -1, best_f[..., None])[..., 0]
        m_prog = torch.gather(merit, -1, f_p.clamp(0, merit.shape[-1] - 1)[..., None])[..., 0]
        fdiff = both & (f_p != best_f)
        amb_f = m_prog >= m_best - 2 * band
        adopted += int((fdiff & amb_f).sum())
        mism += int((fdiff & ~amb_f).sum())
        best_f = torch.where(fdiff & amb_f, f_p, best_f)
        best_c = torch.gather(prep["thr"], -1, best_f[..., None])[..., 0]
        # threshold: the program's must be a candidate boundary of the
        # chosen table whose score is within the band of the best
        rows = prep["rows"]
        F = merit.shape[-1]
        slot = torch.full((attempt.numel(),), -1, dtype=torch.long, device=rows.device)
        slot[rows] = torch.arange(rows.numel(), device=rows.device)
        tt, mm = torch.nonzero(both & ~(fdiff & ~amb_f), as_tuple=True)
        r = slot[tt * M + mm] * F + best_f[tt, mm]
        score, cand = prep["score"][r].double(), prep["cand"][r].double()
        c_prog = c_p[tt, mm].double()
        c_ref = best_c[tt, mm].double()
        same = (c_prog - c_ref).abs() <= THR_BAND * (c_prog.abs() + c_ref.abs() + 1e-30)
        near = (cand - c_prog[:, None]).abs() <= THR_BAND * (
            cand.abs() + c_prog.abs()[:, None] + 1e-30)
        s_at = torch.where(near, score, torch.full_like(score, float("-inf"))).amax(-1)
        ok = s_at >= score.amax(-1) - 2 * band[tt, mm]
        take = ~same & ok
        adopted += int(take.sum())
        mism += int((~same & ~ok).sum())
        best_c[tt[take], mm[take]] = c_p[tt[take], mm[take]].to(best_c.dtype)
    return {"want": want, "best_f": best_f, "best_c": best_c}, mism, adopted


def compare_step(cfg, pre_ref, pre_prog, post_prog, aux, X, y, bag_w, new_masks,
                 prog_leaf):
    """Judge one program step.  ``pre_ref`` is the reference's pre-step
    state (the program's own, or the reference's where it carries its
    own); ``pre_prog``/``post_prog`` the program's states around the step,
    ``aux`` its prequential errors and swap flags, ``prog_leaf`` its
    route's (T, B) leaf ids at ``pre_prog``.  Returns ``(readings,
    ref_post)``."""
    prep = arf.prepare(cfg, pre_ref, X, y, bag_w)
    mine = arf.decide(cfg, prep, pre_ref["feat_mask"])
    route_mm = int((prog_leaf.long() != prep["leaf"]).sum())
    drift_p = aux["drift"].to(torch.bool)
    signal, drift, swap_mm = _reconcile_drift(pre_prog, post_prog, prep, mine, drift_p)
    choice, split_mm, adopted = _reconcile_splits(pre_prog, post_prog, prep, mine,
                                                  drift)
    choice.update(signal=signal, drift=drift)
    ref_post = arf.finish(cfg, pre_ref, prep, choice, new_masks)

    # the batch's weight per leaf, read off the program's target counts:
    # each leaf's count must be its old count plus the reference's batch
    # weight, added in the state's float32 as the merge adds it (past
    # 2**24 a difference of the two counts would round)
    keep = ~drift[:, None]
    was_leaf = pre_prog["trees"]["is_leaf"] & keep
    n_pre, n_post = pre_prog["trees"]["ystats"]["n"], post_prog["trees"]["ystats"]["n"]
    route_mm += int(((n_post != n_pre + prep["batch_n"].to(n_pre.dtype)) & was_leaf).sum())

    p, r = _flat(post_prog), _flat(ref_post)
    worst, worst_key = 0.0, ""
    for key, rv in r.items():
        pv = p[key]
        if pv.dtype in (torch.bool, torch.int32, torch.int64):
            split_mm += int((pv != rv).sum())
            continue
        e = _norm_err(pv, rv)
        if e > worst:
            worst, worst_key = e, key
    pred = max(_norm_err(aux["member_mse"], prep["member_mse"]),
               _norm_err(aux["forest_mse"].reshape(1), prep["forest_mse"].reshape(1)))
    return ({"route_mismatch": route_mm, "choice_mismatch": split_mm + swap_mm,
             "state_err": worst, "pred_err": pred,
             "adopted": adopted, "state_err_at": worst_key,
             "splits": int((pre_prog["trees"]["is_leaf"]
                            & ~post_prog["trees"]["is_leaf"] & keep).sum()),
             "swaps": int(drift_p.sum())}, ref_post)


def _close(a, b):
    """Where ``b`` lies within ROUND_BAND of ``a``, relative to ``a``'s
    entry plus the mean magnitude of ``a``'s non-zero entries."""
    a64, b64 = a.double(), b.double()
    nz = a64 != 0
    s = float(a64.abs()[nz].mean()) if bool(nz.any()) else 0.0
    return (a64 - b64).abs() <= ROUND_BAND * (a64.abs() + s)


def adopt_rounding(mine, prog):
    """Where the reference carries its own state, take over each float
    value of the program's state that agrees with its own within
    ROUND_BAND: a rounding-level value (a threshold, a bin grid, a sum
    summed in another order) would otherwise move a row across a
    boundary or a centroid across another a step later.  Integer and
    boolean arrays (the trees' structure, the resets) stay the
    reference's own, and so does every value outside the band."""
    def walk(a, b):
        if isinstance(a, dict):
            return {k: (walk(v, b[k]) if k in b else v) for k, v in a.items()}
        if a.is_floating_point() and b.shape == a.shape:
            return torch.where(_close(a, b), b.to(a.dtype), a)
        return a
    return walk(mine, prog)


def states_equal(a, b):
    """Whether two forest states hold the same arrays bit for bit."""
    fa, fb = _flat(a), _flat(b)

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)
    return set(fa) == set(fb) and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and torch.equal(raw(fa[k]), raw(fb[k])) for k in fa)


def serve_err(answers, reference):
    """Normalized gap of served answers against the reference's (inf if
    an answer is missing)."""
    if answers.shape != reference.shape:
        return float("inf")
    return _norm_err(answers, reference)


def control_step(cfg, pre, X, y, bag_w, new_masks, dt=torch.bfloat16):
    """The control: the reference computed in ``dt`` (the precision below
    the configuration's float32), put in the program's place and judged
    as the program is."""
    post, prep, choice = arf.step(cfg, arf.cast_state(pre, dt), X, y, bag_w,
                                  new_masks, dt)
    aux = {"member_mse": prep["member_mse"].float(),
           "forest_mse": prep["forest_mse"].float(), "drift": choice["drift"]}
    r, _ = compare_step(cfg, pre, pre, arf.cast_state(post, torch.float32), aux,
                        X, y, bag_w, new_masks, prep["leaf"])
    return r
