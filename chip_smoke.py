#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Configuration ``forest_t16_m1023_f16_c64``: an online-bagged forest of
T=16 QO Hoeffding trees, M=1023 nodes, max depth 12, F=16 features, C=64
bins, learned batches of B=4096 rows.  Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the three CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once) into ``build/kernels/``;
3. per kernel, at the shapes of a live forest after 8 learned batches:
   kernel vs its plain PyTorch version on the card (route ids exact,
   absorb n exact, absorb mean/m2/sum_x and query merit/thr within 1e-4
   relative with an absolute floor of 1e-4, identical -inf pattern), and
   both timed (median of CUDA-event-timed repeats);
4. end to end: 32 batches through ``forest.update`` with the launch counts
   set to 0 just before and read just after; every kernel must have run;
5. determinism: the same seed again gives a bitwise-equal state;
6. serving: ``freeze`` + ``predict_snapshot`` of an 8192-row request equals
   the live ``forest.predict`` bit for bit;
7. where the time goes: 8 mid-growth steps (after 8 warm-up batches)
   timed plain and under torch.profiler, printing the device-busy share
   and the top device kernels and host operations.

Prints one JSON line of per-kernel numbers, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero, with
no result, when no GPU is visible.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

T, M, F, C, DEPTH, B = 16, 1023, 16, 64, 12, 4096
WARM_BATCHES, STREAM_BATCHES, SERVE_ROWS = 8, 32, 8192
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores


def _close(a, b, what):
    """|a-b| <= TOL*|b| + TOL elementwise, with identical -inf positions."""
    import torch
    ninf_a, ninf_b = torch.isneginf(a), torch.isneginf(b)
    if not torch.equal(ninf_a, ninf_b):
        raise AssertionError(f"{what}: -inf patterns differ "
                             f"({int((ninf_a != ninf_b).sum())} entries)")
    fa, fb = a[~ninf_a].double(), b[~ninf_b].double()
    err = (fa - fb).abs()
    bad = err > TOL * fb.abs() + TOL
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} entries beyond "
                             f"tolerance, max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _time_ms(fn, reps=20, warm=3):
    """Median CUDA-event time of one call, in ms."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _profile(cfg, batches, seed, dev):
    """Phase 7: where the time of a mid-growth learned batch goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import forest as fr
    state = fr.init_forest(cfg, seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    window = batches[WARM_BATCHES:2 * WARM_BATCHES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for Xb, yb in window:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    state = fr.init_forest(cfg, seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for Xb, yb in window:
            state, _ = fr.update(cfg, state, Xb, yb, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    # device-side events only (kernels, copies): an ATen op's own
    # self_device_time_total repeats the time of the kernels it launched
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    n = len(window)
    print(f"[7] {n} mid-growth steps: {plain_wall / n * 1e3:.3f} ms/step "
          f"unprofiled; profiled {wall / n * 1e3:.3f} ms/step with device "
          f"busy {busy / n:.3f} ms/step ({busy / (wall * 1e3):.1%} of wall)")
    for e in kernels:
        if e.key.startswith("qo_"):
            print(f"[7] device time of {e.key.split('(')[0]}: "
                  f"{e.self_device_time_total / 1e3 / e.count:.4f} ms per "
                  f"launch, {e.count / n:.1f} launches per step")
    print("[7] top device kernels (ms per step, calls per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}")
    print("[7] top operations by host time (ms per step, calls per step):")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"    {e.self_cpu_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import forest as fr
    from repro_torch.core import hoeffding as ht
    from repro_torch.core import serve as sv
    from repro_torch.core import stats
    from repro_torch.data import synth
    from repro_torch.kernels import _build, qo_query_batched, qo_route
    from repro_torch.kernels import qo_update_leaves

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1] card: {smi}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[2] built {len(libs)} kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}")

    cfg = fr.ForestConfig(
        tree=ht.HTRConfig(n_features=F, max_nodes=M, n_bins=C,
                          grace_period=200, max_depth=DEPTH),
        n_trees=T, lam=6.0, subspace=0.7)
    n_rows = STREAM_BATCHES * B
    X_all, y_all = synth.piecewise_regression(n_rows, F, seed=args.seed)
    batches = [(torch.as_tensor(X_all[i:i + B], device=dev),
                torch.as_tensor(y_all[i:i + B], device=dev))
               for i in range(0, n_rows, B)]

    # ---- 3. per kernel at the full-width shapes -------------------------
    state = fr.init_forest(cfg, args.seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    trees = state["trees"]
    Xk, yk = batches[WARM_BATCHES]
    depth = ht.realized_depth(cfg.tree, trees["depth"])
    rows = []

    folded = qo_route.fold_route_tables(trees["feature"], trees["threshold"],
                                        trees["child"], trees["is_leaf"])
    route_k = qo_route.route_kernel(*folded, Xk, T, M, depth)
    route_p = qo_route.route_plain(*folded, Xk, T, M, depth)
    if not torch.equal(route_k, route_p):
        raise AssertionError("qo_route: leaf ids differ from the plain "
                             "version")
    nbytes = Xk.numel() * 4 + T * M * 16 + T * B * 4
    bound, by = _bound(nbytes, T * B * depth * 2)
    rows.append(dict(
        name="qo_route", route="cuda",
        source="src/repro_torch/csrc/qo_route.cu",
        replaces="src/repro/kernels/qo_route.py:151",
        max_abs_err=0.0,
        ms=_time_ms(lambda: qo_route.route_kernel(*folded, Xk, T, M, depth)),
        plain_ms=_time_ms(lambda: qo_route.route_plain(*folded, Xk, T, M,
                                                       depth)),
        bound_ms=bound, bound_by=by, library_ms=None))
    print(f"[3] qo_route: ids exact, depth {depth}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    w = torch.randint(0, 7, (T, B), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32).reshape(-1)
    gl = (torch.arange(T, device=dev, dtype=torch.int32)[:, None] * M
          + route_k).reshape(-1)
    fold = lambda a: a.reshape((T * M,) + a.shape[2:])
    radius, origin = fold(trees["ao_radius"]), fold(trees["ao_origin"])

    def tables():
        return ({k: fold(v).clone() for k, v in trees["ao_y"].items()},
                fold(trees["ao_sum_x"]).clone())

    ty_k, tsx_k = tables()
    ty_p, tsx_p = tables()
    qo_update_leaves.absorb_kernel(ty_k, tsx_k, radius, origin, gl, Xk, yk, w)
    qo_update_leaves.absorb_plain(ty_p, tsx_p, radius, origin, gl, Xk, yk, w)
    if not torch.equal(ty_k["n"], ty_p["n"]):
        raise AssertionError("qo_update_leaves: n differs from the plain "
                             "version")
    err = max(_close(ty_k[k], ty_p[k], f"qo_update_leaves {k}")
              for k in ("mean", "m2"))
    err = max(err, _close(tsx_k, tsx_p, "qo_update_leaves sum_x"))
    touched = int((torch.bincount(gl, minlength=T * M) > 0).sum())
    tab_bytes = touched * F * (C * 4 * 4 * 2 + 2 * 4)
    nbytes = Xk.numel() * 4 + B * 4 + T * B * 8 + tab_bytes
    flops = T * B * F * 16 + touched * F * C * 14
    bound, by = _bound(nbytes, flops)
    scratch_k, scratch_p = tables(), tables()
    rows.append(dict(
        name="qo_update_leaves", route="cuda",
        source="src/repro_torch/csrc/qo_update_leaves.cu",
        replaces="src/repro/kernels/qo_update_leaves.py:187",
        max_abs_err=err,
        ms=_time_ms(lambda: qo_update_leaves.absorb_kernel(
            *scratch_k, radius, origin, gl, Xk, yk, w)),
        plain_ms=_time_ms(lambda: qo_update_leaves.absorb_plain(
            *scratch_p, radius, origin, gl, Xk, yk, w)),
        bound_ms=bound, bound_by=by, library_ms=None))
    print(f"[3] qo_update_leaves: n exact, {touched} leaves touched, "
          f"max abs err {err:.3g}", flush=True)

    # the attempt set the main path would query after absorbing this batch
    batch_leaf = ht.segment_stats(yk.repeat(T), gl, T * M, w)
    after = dict(trees,
                 ystats=stats.merge({k: fold(v) for k, v in
                                     trees["ystats"].items()}, batch_leaf),
                 seen_since_attempt=fold(trees["seen_since_attempt"])
                 + batch_leaf["n"],
                 is_leaf=fold(trees["is_leaf"]), depth=fold(trees["depth"]))
    attempt = ht.attempt_mask(cfg.tree, after) & (
        trees["n_nodes"].repeat_interleave(M) + 1 < M)
    qrows = torch.nonzero(attempt).reshape(-1).to(torch.int32)
    K = qrows.numel()
    if K == 0:
        raise AssertionError("qo_query_batched: no leaf attempts a split")
    merit_k, thr_k = qo_query_batched.best_splits_kernel(ty_k, tsx_k, qrows)
    merit_p, thr_p = qo_query_batched.best_splits_plain(ty_k, tsx_k, qrows)
    err = _close(merit_k, merit_p, "qo_query_batched merit")
    # a threshold may only differ where the kernel's boundary ties the
    # plain version's best within tolerance (f32 order can flip a tie)
    flat = lambda a: a[qrows.long()].reshape(K * F, C)
    score, cand = qo_query_batched.query_scores_plain(
        flat(ty_k["n"]), flat(ty_k["mean"]), flat(ty_k["m2"]), flat(tsx_k))
    tk, tp = thr_k.reshape(-1), thr_p.reshape(-1)
    diff = ((tk - tp).abs() > TOL * tp.abs() + TOL).nonzero().reshape(-1)
    for i in diff.tolist():
        hit = (cand[i] == tk[i]).nonzero().reshape(-1)
        best = float(merit_p.reshape(-1)[i])
        if hit.numel() == 0 or abs(float(score[i, hit[0]]) - best) \
                > TOL * abs(best) + TOL:
            raise AssertionError(f"qo_query_batched: threshold of table {i} "
                                 f"is not a near-tie of the best boundary")
    nbytes = K * F * C * 16 + K * 4 + K * F * 8
    bound, by = _bound(nbytes, K * F * C * 30)
    rows.append(dict(
        name="qo_query_batched", route="cuda",
        source="src/repro_torch/csrc/qo_query_batched.cu",
        replaces="src/repro/kernels/qo_query_batched.py:151",
        max_abs_err=err,
        ms=_time_ms(lambda: qo_query_batched.best_splits_kernel(
            ty_k, tsx_k, qrows)),
        plain_ms=_time_ms(lambda: qo_query_batched.best_splits_plain(
            ty_k, tsx_k, qrows)),
        bound_ms=bound, bound_by=by, library_ms=None))
    print(f"[3] qo_query_batched: K={K} tables x {F} features, "
          f"{len(diff)} near-tie thresholds, max abs err {err:.3g}",
          flush=True)
    del ty_k, tsx_k, ty_p, tsx_p, scratch_k, scratch_p, state, trees, after

    # ---- 4. end to end ----------------------------------------------------
    def stream():
        st = fr.init_forest(cfg, args.seed, device=dev)
        mse = []
        for Xb, yb in batches:
            st, aux = fr.update(cfg, st, Xb, yb, device=dev)
            mse.append(float(aux["forest_mse"]))
        return st, mse

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, mse = stream()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"[4] forest_mse per batch: "
          + " ".join(f"{m:.4f}" for m in mse))
    print(f"[4] nodes per tree: {state['trees']['n_nodes'].tolist()}")
    print(f"[4] {STREAM_BATCHES} batches of {B} rows in {secs:.3f} s: "
          f"{STREAM_BATCHES * B / secs:.0f} rows/s")
    print(f"[4] kernels {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if not (np.isfinite(mse).all() and mse[-1] < mse[0]):
        raise AssertionError(f"prequential forest_mse did not fall: {mse}")

    # ---- 5. determinism ---------------------------------------------------
    again, mse2 = stream()

    def same(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        elif not torch.equal(a, b):
            raise AssertionError(f"rerun differs at {path}")

    same(state, again)
    if mse != mse2:
        raise AssertionError("rerun forest_mse trace differs")
    print("[5] rerun from the same seed: bitwise-equal state", flush=True)
    del again

    # ---- 6. serving -------------------------------------------------------
    snap = sv.freeze(state, device=dev)
    Xs, _ = synth.piecewise_regression(SERVE_ROWS, F, seed=args.seed + 7)
    Xs = torch.as_tensor(Xs, device=dev)
    _build.reset_launches()
    served = sv.predict_snapshot(snap, Xs, device=dev)
    torch.cuda.synchronize()
    serve_launches = _build.LAUNCHES["qo_route"]
    live = fr.predict(cfg, state, Xs, device=dev)
    if serve_launches <= 0 or not torch.equal(served, live):
        raise AssertionError("snapshot serving differs from live predict")
    serve_ms = _time_ms(lambda: sv.predict_snapshot(snap, Xs, device=dev))
    print(f"[6] snapshot depth {snap.depth}, {snap.feature.shape[1]} slots: "
          f"equals live predict bitwise; {SERVE_ROWS} rows in "
          f"{serve_ms:.3f} ms = {SERVE_ROWS / serve_ms * 1e3:.0f} rows/s",
          flush=True)

    _profile(cfg, batches, args.seed, dev)

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
