#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Four paths at full width, each fatal on failure:

* ``forest_t16_m1023_f16_c64``: an online-bagged forest of T=16 QO
  Hoeffding trees, M=1023 nodes, max depth 12, F=16 features, C=64 bins,
  learned batches of B=4096 rows;
* ``forest_t16_m1023_f16_k16_sketch``: the same forest with
  ``observer_backend="sketch"``, K=16 centroids per (leaf, feature), on
  the same stream fed as exp(X) (heavy-tailed; monotone, so the planted
  splits survive);
* ``qo_c1024_n1e6``: the single-table QO observer (paper Algorithms 1 and
  2) on the paper's §5.1 streams of 1,000,000 rows, C=1024 bins;
* ``dp_t16_m1023_f16_c64_d4``: data-parallel stream training of the first
  forest (DESIGN.md §4.1) with D=4 shards on the one card
  (``build_data_parallel_reference``: what each rank of a 4-GPU run
  computes), global batches of B=4096 rows (1024 a shard), a sync every
  2 batches.

Phases:

1. the card's name and power limit (nvidia-smi);
2. build the seven CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) into ``build/kernels/``;
3. per kernel, at the shapes its path gives it (the forests after 8
   learned batches, one table absorbing a 1e6-row stream, the first reduce
   level of the D=4 sync after 8 DP batches): kernel vs its
   plain PyTorch version on the card (ids and counts exact; other
   statistics, merits and thresholds within 1e-4 relative with an
   absolute floor of 1e-4 -- for the single table, relative to each bin's
   sum of |terms| and to the table's variance, since sums of 1e6 mixed-sign
   terms cancel -- identical -inf patterns, a threshold differing only at
   a near-tie; the Chan merge bitwise), and both timed (median of
   CUDA-event-timed repeats); both absorbs run twice and the runs
   compared bitwise, the forest absorb also on a fresh forest's first batch (every
   row in one of the 16 roots, 4,096 rows a leaf: several pieces a leaf),
   the single-table absorb also with all 1e6 rows in one bin;
4. QO forest end to end: 32 batches through ``forest.update`` with the
   launch counts set to 0 just before and read just after; every kernel
   of the path must have run;
5. determinism: the same seed again gives a bitwise-equal state;
6. serving: ``freeze`` + ``predict_snapshot`` of an 8192-row request equals
   the live ``forest.predict`` bit for bit;
7. where the time goes: 8 mid-growth steps (after 8 warm-up batches)
   timed plain and under torch.profiler, printing the device-busy share
   and the top device kernels and host operations (for both forests);
8. sketch forest end to end: 32 batches with counts reset, falling MSE, a
   bitwise rerun, a snapshot serving equal to live ``predict``;
9. single-table QO: the 18 streams of the §5.1 grid (3 distributions x 3
   parameterizations x 2 targets, noise on 10 %, n = 1e6) each absorbed
   in one ``qo.update`` into a C=1024 table at radius sigma/2
   (``auto_radius``, k=2) and queried with ``qo.best_split``, with counts
   reset; each held against the plain versions and its merit against the
   exhaustive best split; then the quickstart stream at r=0.01, which
   must find the planted x=0.3 within 0.1;
10. data-parallel training end to end: 32 global batches with the counts
    reset (``qo_merge`` 3 launches a sync: two reduce levels and the
    apply), the member MSE reported at the syncs falling, every tree
    grown, ``on_sync`` at every boundary, a bitwise rerun,
    ``update_window`` (S=2) equal to two ``update`` calls, a snapshot
    frozen at the last sync serving equal to live ``predict``, and
    ``build_data_parallel_forest`` in a one-rank NCCL group equal to the
    one-shard reference after 8 batches; then the same checks for the
    sketch forest at D=2 over 8 batches (``sketch_merge`` in the reduce,
    no ``qo_merge``);
11. where the DP time goes: 8 global batches (4 syncs) after 8 warm-up
    batches, timed per call and under torch.profiler: ms per global batch
    and per sync, the device-busy share, the top device kernels and host
    operations.

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
KS = 16                        # sketch centroids per (leaf, feature)
QO_BINS, QO_ROWS = 1024, 1_000_000
DP_SHARDS, DP_SYNC, DP_SKETCH_SHARDS = 4, 2, 2
WARM_BATCHES, STREAM_BATCHES, SERVE_ROWS = 8, 32, 8192
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores


def _close(a, b, what, scale=0.0):
    """|a-b| <= TOL*(|b| + scale) + TOL elementwise, with identical -inf
    positions (``scale``: the magnitude a sum's rounding follows)."""
    import torch
    ninf_a, ninf_b = torch.isneginf(a), torch.isneginf(b)
    if not torch.equal(ninf_a, ninf_b):
        raise AssertionError(f"{what}: -inf patterns differ "
                             f"({int((ninf_a != ninf_b).sum())} entries)")
    fa, fb = a[~ninf_a].double(), b[~ninf_b].double()
    if torch.is_tensor(scale):
        scale = scale[~ninf_b].double()
    err = (fa - fb).abs()
    bad = err > TOL * (fb.abs() + scale) + TOL
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


def _device_ms(fn, reps=10):
    """Device time of one call of ``fn``, in ms: the profiler's CUDA
    kernel time over ``reps`` calls (after a warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


def _bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _profile(cfg, batches, seed, dev, tag="[7]"):
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
    _report(prof, len(window), wall, plain_wall, "mid-growth steps", tag)


def _report(prof, n, wall, plain_wall, what, tag):
    """Print a profiled window: wall times, device-busy share, the port's
    kernels, the top device kernels and the top host operations."""
    import torch
    ev = prof.key_averages()
    # device-side events only (kernels, copies): an ATen op's own
    # self_device_time_total repeats the time of the kernels it launched
    kernels = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"{tag} {n} {what}: {plain_wall / n * 1e3:.3f} ms each "
          f"unprofiled; profiled {wall / n * 1e3:.3f} ms each with device "
          f"busy {busy / n:.3f} ms ({busy / (wall * 1e3):.1%} of wall)")
    calls = {}
    for e in kernels:
        if e.key.startswith(("qo_", "sketch_")):
            name = e.key.split('(')[0]
            print(f"{tag} device time of {name}: "
                  f"{e.self_device_time_total / 1e3 / e.count:.4f} ms per "
                  f"launch, {e.count / n:.1f} launches each")
            wrapper = _wrapper_of(name)
            ms, count = calls.get(wrapper, (0.0, 0))
            calls[wrapper] = (ms + e.self_device_time_total / 1e3,
                              max(count, e.count))
    for wrapper, (ms, count) in sorted(calls.items()):
        print(f"{tag} device time of the {wrapper} wrapper: "
              f"{ms / count:.4f} ms per call (its kernels together), "
              f"{count / n:.1f} calls each")
    print(f"{tag} top device kernels (ms each, calls each):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}")
    print(f"{tag} top operations by host time (ms each, calls each):")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"    {e.self_cpu_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}", flush=True)


def _wrapper_of(kernel):
    """The wrapper (a key of ``_build.LAUNCHES``) that launches a CUDA
    kernel: the longest wrapper name the kernel's name starts with."""
    from repro_torch.kernels import _build
    names = [w for w in _build.LAUNCHES if kernel.startswith(w)]
    return max(names, key=len) if names else kernel


def _tables_equal(a, b, what):
    """Bitwise equality of two (Stats dict, sum_x) table sets."""
    import torch
    (ay, asx), (by, bsx) = a, b
    if not all(torch.equal(ay[k], by[k]) for k in ("n", "mean", "m2")) \
            or not torch.equal(asx.nan_to_num(), bsx.nan_to_num()):
        raise AssertionError(f"{what}: a rerun differs")


def _absorb_first_batch(cfg, batches, seed, dev):
    """Phase 3 (i): the forest absorb on a fresh forest's first batch,
    every row of every tree in its root (16 leaves of 4,096 rows: the
    path with several pieces a leaf), against the plain version and
    rerun."""
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.kernels import qo_update_leaves
    trees = fr.init_forest(cfg, seed, device=dev)["trees"]
    Xk, yk = batches[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    w = torch.randint(0, 7, (T * B,), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32)
    gl = torch.arange(T, device=dev, dtype=torch.int32).repeat_interleave(B) \
        * M
    fold = lambda a: a.reshape((T * M,) + a.shape[2:])
    radius, origin = fold(trees["ao_radius"]), fold(trees["ao_origin"])

    def tables():
        return ({k: fold(v).clone() for k, v in trees["ao_y"].items()},
                fold(trees["ao_sum_x"]).clone())

    rows = qo_update_leaves.sort_rows(gl, T * M)
    out_k, out_r, out_p = tables(), tables(), tables()
    qo_update_leaves.absorb_kernel(*out_k, radius, origin, gl, Xk, yk, w,
                                   rows)
    qo_update_leaves.absorb_kernel(*out_r, radius, origin, gl, Xk, yk, w,
                                   rows)
    qo_update_leaves.absorb_plain(*out_p, radius, origin, gl, Xk, yk, w)
    if not torch.equal(out_k[0]["n"], out_p[0]["n"]):
        raise AssertionError("qo_update_leaves (first batch): n differs "
                             "from the plain version")
    err = max(_close(out_k[0][k], out_p[0][k],
                     f"qo_update_leaves (first batch) {k}")
              for k in ("mean", "m2"))
    err = max(err, _close(out_k[1], out_p[1],
                          "qo_update_leaves (first batch) sum_x"))
    _tables_equal(out_k, out_r, "qo_update_leaves (first batch)")
    scratch = tables()
    ms = _time_ms(lambda: qo_update_leaves.absorb_kernel(
        *scratch, radius, origin, gl, Xk, yk, w,
        qo_update_leaves.sort_rows(gl, T * M)))
    print(f"[3] qo_update_leaves, a fresh forest's first batch ({T} roots "
          f"of {B} rows, {B // qo_update_leaves.PIECE_ROWS} pieces each): "
          f"n exact, max abs err {err:.3g}, rerun bitwise equal, "
          f"{ms:.4f} ms a call with its sort", flush=True)


def _sketch_compact_row(scfg, sbatches, seed, dev):
    """Phase 3: the compaction kernel on the tables of a sketch forest
    after 8 learned batches, absorbing the next batch."""
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.core import hoeffding as ht
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sketch_compact
    state = fr.init_forest(scfg, seed, device=dev)
    for Xb, yb in sbatches[:WARM_BATCHES]:
        state, _ = fr.update(scfg, state, Xb, yb, device=dev)
    trees = state["trees"]
    Xk, yk = sbatches[WARM_BATCHES]
    leaf = kops.forest_route(trees["feature"], trees["threshold"],
                             trees["child"], trees["is_leaf"], Xk,
                             depth=ht.realized_depth(scfg.tree,
                                                     trees["depth"]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    w = torch.randint(0, 7, (T * B,), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32)
    gl = (torch.arange(T, device=dev, dtype=torch.int32)[:, None] * M
          + leaf).reshape(-1)
    fold = lambda a: a.reshape((T * M,) + a.shape[2:])
    old = [fold(trees["ao_y"][k]) for k in ("n", "mean", "m2")] \
        + [fold(trees["ao_sum_x"])]
    new = sk.from_batch_planes(gl, Xk, yk, w, T * M, KS)
    cat = [torch.cat([a, b], -1) for a, b in zip(old, new)]
    planes = [a.contiguous() for a in sk.sort_planes(*cat)]
    bucket = sk._bucket_ids(planes[0], KS)
    out_k = sketch_compact.bucket_reduce_kernel(*planes, bucket, KS)
    out_p = sketch_compact.bucket_reduce_plain(*planes, bucket, KS)
    if not torch.equal(out_k[0], out_p[0]):
        raise AssertionError("sketch_compact: n differs from the plain "
                             "version")
    err = max(_close(a, b, f"sketch_compact {name}") for a, b, name in
              zip(out_k[1:], out_p[1:], ("mean", "m2", "sum_x")))
    R, J = T * M * F, 2 * KS
    bound, by = _bound(5 * R * J * 4 + 4 * R * KS * 4, R * J * 12)
    print(f"[3] sketch_compact: R={R} rows, J={J} -> K={KS}, n exact, "
          f"max abs err {err:.3g}", flush=True)
    return dict(
        name="sketch_compact", route="cuda",
        source="src/repro_torch/csrc/sketch_compact.cu",
        replaces="src/repro/kernels/sketch_compact.py:110",
        max_abs_err=err,
        ms=_time_ms(lambda: sketch_compact.bucket_reduce_kernel(
            *planes, bucket, KS)),
        plain_ms=_time_ms(lambda: sketch_compact.bucket_reduce_plain(
            *planes, bucket, KS)),
        bound_ms=bound, bound_by=by, library_ms=None)


def _qo_planes(table):
    return (table["y"]["n"], table["y"]["mean"], table["y"]["m2"],
            table["sum_x"])


def _check_qo_update(out_k, out_p, table, x, y, w, what):
    """Kernel vs plain absorb of one table, the plain version summing in
    float64 (its float32 sums of ~10^5 rows a bin go through atomics and
    stray by more than the kernel's tree sums): n exact; mean and sum_x
    within TOL of each bin's sum of |terms| (1e6 mixed-sign terms cancel),
    m2 relative.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.qo_update_leaves import bin_ids_plain
    if not torch.equal(out_k[0], out_p[0]):
        raise AssertionError(f"{what}: n differs from the plain version")
    ids = bin_ids_plain(table["radius"], table["origin"], x,
                        QO_BINS).long()
    n0, mean0, _, sx0 = _qo_planes(table)
    absum = lambda v: torch.zeros(QO_BINS, dtype=torch.float32,
                                  device=x.device).index_add_(0, ids, v)
    finite = torch.isfinite(x)
    y_scale = (n0 * mean0.abs() + absum((w * y).abs())) \
        / torch.clamp(out_k[0], min=1.0)
    sx_scale = sx0.abs() + absum(torch.where(finite, (w * x).abs(), 0.0))
    return max(_close(out_k[1], out_p[1], f"{what} mean", y_scale),
               _close(out_k[2], out_p[2], f"{what} m2"),
               _close(out_k[3], out_p[3], f"{what} sum_x", sx_scale))


def _check_qo_query(planes, k, p, what):
    """Kernel vs plain query of one table: scores within TOL of the
    table's variance, thresholds close, the same validity, and a best
    threshold that differs only at a near-tie.  Returns the max abs
    error."""
    import torch
    from repro_torch.core import stats
    (ks, kc, kr), (ps, pc, pr) = k, p
    s2 = float(stats.variance(stats.tree_reduce_merge(
        {"n": planes[0], "mean": planes[1], "m2": planes[2]}, 0)))
    err = max(_close(ks, ps, f"{what} score", s2),
              _close(kc, pc, f"{what} threshold row"),
              _close(kr[1:2], pr[1:2], f"{what} merit", s2))
    if float(kr[2]) != float(pr[2]):
        raise AssertionError(f"{what}: validity differs")
    if abs(float(kr[0]) - float(pr[0])) > TOL * abs(float(pr[0])) + TOL:
        hit = (pc == kr[0]).nonzero().reshape(-1)
        if hit.numel() == 0 or abs(float(ps[hit[0]]) - float(pr[1])) \
                > TOL * (abs(float(pr[1])) + s2) + TOL:
            raise AssertionError(f"{what}: the best threshold is not a "
                                 f"near-tie of the plain version's")
    return err


def _paper_stream(cfg, dev):
    import torch
    from repro_torch.data import synth
    x, y = synth.generate(cfg)
    return (torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))


def _qo_rows(seed, dev):
    """Phase 3: the single-table absorb and query kernels on a table that
    already holds one 1e6-row stream, absorbing a second one."""
    import torch
    from repro_torch.core import qo
    from repro_torch.data import synth
    from repro_torch.kernels import qo_query, qo_update
    xw, yw = _paper_stream(synth.SynthConfig(noise_frac=0.1, n=QO_ROWS,
                                             seed=seed + 100), dev)
    r, o = qo.auto_radius(xw, k=2.0)
    table = qo.update(qo.init(QO_BINS, r, o, device=dev), xw, yw, device=dev)
    x, y = _paper_stream(synth.SynthConfig(noise_frac=0.1, n=QO_ROWS,
                                           seed=seed), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    w = torch.randint(0, 5, (QO_ROWS,), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32)
    args = (*_qo_planes(table), table["radius"], table["origin"], x, y, w)
    out_k = qo_update.update_kernel(*args)
    out_p = qo_update.update_plain(*(a.double() for a in args))
    err = _check_qo_update(out_k, out_p, table, x, y, w, "qo_update")
    if not all(torch.equal(a, b) for a, b in
               zip(out_k, qo_update.update_kernel(*args))):
        raise AssertionError("qo_update: a rerun differs")
    # (ii) every row in one bin: x constant
    xc = torch.full_like(x, float(table["origin"]))
    one = (*_qo_planes(table), table["radius"], table["origin"], xc, y, w)
    one_k = qo_update.update_kernel(*one)
    _check_qo_update(one_k, qo_update.update_plain(*(a.double() for a in one)),
                     table, xc, y, w, "qo_update (one bin)")
    if not all(torch.equal(a, b) for a, b in
               zip(one_k, qo_update.update_kernel(*one))):
        raise AssertionError("qo_update (one bin): a rerun differs")
    one_ms = _time_ms(lambda: qo_update.update_kernel(*one))
    print(f"[3] qo_update: {QO_ROWS} rows in one bin: n exact, rerun "
          f"bitwise equal, {one_ms:.4f} ms a call", flush=True)
    bound, by = _bound(QO_ROWS * 12 + QO_BINS * 16 * 2 + 8, QO_ROWS * 20)
    rows = [dict(
        name="qo_update", route="cuda", source="src/repro_torch/csrc/qo_update.cu",
        replaces="src/repro/kernels/qo_update.py:108", max_abs_err=err,
        ms=_time_ms(lambda: qo_update.update_kernel(*args)),
        plain_ms=_time_ms(lambda: qo_update.update_plain(*args)),
        bound_ms=bound, bound_by=by, library_ms=None)]
    dev_ms = _device_ms(lambda: qo_update.update_kernel(*args))
    print(f"[3] qo_update: C={QO_BINS}, N={QO_ROWS}, n exact, max abs err "
          f"{err:.3g}, rerun bitwise equal; device {dev_ms:.4f} ms a call "
          f"(bound {bound:.5f} ms)", flush=True)
    planes = [a.contiguous() for a in out_k]
    k, p = qo_query.best_kernel(*planes), qo_query.best_plain(*planes)
    err = _check_qo_query(planes, k, p, "qo_query")
    bound, by = _bound(QO_BINS * 16 + QO_BINS * 8 + 12, QO_BINS * 60)
    rows.append(dict(
        name="qo_query", route="cuda", source="src/repro_torch/csrc/qo_query.cu",
        replaces="src/repro/kernels/qo_query.py:121", max_abs_err=err,
        ms=_time_ms(lambda: qo_query.best_kernel(*planes)),
        plain_ms=_time_ms(lambda: qo_query.best_plain(*planes)),
        bound_ms=bound, bound_by=by, library_ms=None))
    print(f"[3] qo_query: C={QO_BINS}, {int((planes[0] > 0).sum())} occupied "
          f"bins, threshold {float(k[2][0]):.5f}, max abs err {err:.3g}",
          flush=True)
    return rows


def _exact_merit(x, y):
    """The exhaustive best split's VR (float64 on the card)."""
    import torch
    o = torch.argsort(x)
    xs, ys = x[o].double(), y[o].double()
    n = ys.shape[0]
    cs, cq = torch.cumsum(ys, 0), torch.cumsum(ys * ys, 0)
    nl = torch.arange(1, n, dtype=torch.float64, device=x.device)
    nr = n - nl
    sl, ql = cs[:-1], cq[:-1]
    sr, qr = cs[-1] - sl, cq[-1] - ql
    vl = torch.where(nl > 1, (ql - sl * sl / nl) / torch.clamp(nl - 1, min=1),
                     0.0)
    vr = torch.where(nr > 1, (qr - sr * sr / nr) / torch.clamp(nr - 1, min=1),
                     0.0)
    m = torch.var(ys) - nl / n * vl - nr / n * vr
    m = torch.where(xs[:-1] < xs[1:], m, float("-inf"))
    return float(m.max())


def _sketch_forest(scfg, sbatches, seed, dev):
    """Phase 8: the sketch forest end to end, rerun and served."""
    import numpy as np
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.core import serve as sv
    from repro_torch.kernels import _build

    def stream():
        st = fr.init_forest(scfg, seed, device=dev)
        mse = []
        for Xb, yb in sbatches:
            st, aux = fr.update(scfg, st, Xb, yb, device=dev)
            mse.append(float(aux["forest_mse"]))
        return st, mse

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    state, mse = stream()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print("[8] sketch forest_mse per batch: "
          + " ".join(f"{m:.4f}" for m in mse))
    print(f"[8] nodes per tree: {state['trees']['n_nodes'].tolist()}")
    print(f"[8] {STREAM_BATCHES} batches of {B} rows in {secs:.3f} s: "
          f"{STREAM_BATCHES * B / secs:.0f} rows/s")
    print(f"[8] kernels {json.dumps(launches)}", flush=True)
    for name in ("qo_route", "sketch_compact", "qo_query_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the sketch path")
    if launches["qo_update_leaves"] != 0:
        raise AssertionError("the QO absorb ran under the sketch observer")
    if not (np.isfinite(mse).all() and mse[-1] < mse[0]):
        raise AssertionError(f"sketch forest_mse did not fall: {mse}")
    again, mse2 = stream()
    for k in state["trees"]:
        a, b = state["trees"][k], again["trees"][k]
        pairs = zip(a.values(), b.values()) if isinstance(a, dict) \
            else [(a, b)]
        if not all(torch.equal(u, v) for u, v in pairs) or mse != mse2:
            raise AssertionError(f"sketch rerun differs at trees/{k}")
    print("[8] rerun from the same seed: bitwise-equal state", flush=True)
    Xs = sbatches[-1][0]
    snap = sv.freeze(state, device=dev)
    if not torch.equal(sv.predict_snapshot(snap, Xs, device=dev),
                       fr.predict(scfg, state, Xs, device=dev)):
        raise AssertionError("sketch snapshot differs from live predict")
    print(f"[8] snapshot depth {snap.depth}: equals live predict bitwise",
          flush=True)
    return launches


def _paper_grid(seed, dev):
    """Phase 9: the single-table QO over the §5.1 grid and the quickstart
    stream."""
    import numpy as np
    import torch
    from repro_torch.core import qo
    from repro_torch.data import synth
    from repro_torch.kernels import _build, qo_query, qo_update

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    streams = [synth.SynthConfig(dist, v, task, 0.1, QO_ROWS, seed)
               for dist in synth.DISTRIBUTIONS for v in range(3)
               for task in synth.TASKS]
    torch.cuda.synchronize()
    _build.reset_launches()
    checked = []
    for cfg in streams:
        x, y = _paper_stream(cfg, dev)
        r, o = qo.auto_radius(x, k=2.0)
        empty = qo.init(QO_BINS, r, o, device=dev)
        table, upd_ms = timed(lambda: qo.update(empty, x, y, device=dev))
        split, q_ms = timed(lambda: qo.best_split(table, device=dev))
        checked.append((cfg, empty, table, x, y, split, upd_ms, q_ms))
    rng = np.random.default_rng(0)
    xq = rng.normal(0, 1, 20_000).astype(np.float32)
    yq = np.where(xq <= 0.3, 1.0, 6.0).astype(np.float32) + \
        0.1 * rng.normal(0, 1, 20_000).astype(np.float32)
    quick = qo.update(qo.init(QO_BINS, 0.01, float(np.mean(xq)), device=dev),
                      xq, yq, device=dev)
    qsplit = qo.best_split(quick, device=dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[9] kernels {json.dumps(launches)}", flush=True)
    for name in ("qo_update", "qo_query"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the QO path")

    # against the plain versions and the exhaustive best split
    ones = None
    for cfg, empty, table, x, y, split, upd_ms, q_ms in checked:
        what = f"{cfg.dist}/{cfg.variant}/{cfg.task}"
        ones = torch.ones_like(x) if ones is None else ones
        plain = qo_update.update_plain(*(a.double() for a in (
            *_qo_planes(empty), empty["radius"], empty["origin"], x, y,
            ones)))
        _check_qo_update(_qo_planes(table), plain, empty, x, y, ones, what)
        planes = [a.contiguous() for a in _qo_planes(table)]
        _check_qo_query(planes, qo_query.best_kernel(*planes),
                        qo_query.best_plain(*planes), what)
        exact = _exact_merit(x, y)
        ratio = float(split.merit) / exact
        print(f"[9] {what:18s} slots {int(qo.n_slots(table)):4d} "
              f"update {upd_ms:.3f} ms query {q_ms:.3f} ms  threshold "
              f"{float(split.threshold):+.5f}  merit/exhaustive "
              f"{ratio:.4f}", flush=True)
        if not (bool(split.valid) and 0.9 <= ratio <= 1.0 + 1e-3):
            raise AssertionError(f"{what}: QO merit {float(split.merit)} vs "
                                 f"exhaustive {exact}")
    print(f"[9] quickstart r=0.01: split {float(qsplit.threshold):+.4f} "
          f"(planted 0.3), {int(qo.n_slots(quick))} slots", flush=True)
    if abs(float(qsplit.threshold) - 0.3) >= 0.1:
        raise AssertionError("quickstart: the planted split was not found")

    # where the time of one stream's update + query goes
    from torch.profiler import ProfilerActivity, profile
    _, empty, _, x, y, _, _, _ = checked[0]

    def absorb_and_query():
        qo.best_split(qo.update(empty, x, y, device=dev), device=dev)

    for _ in range(3):
        absorb_and_query()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        absorb_and_query()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            absorb_and_query()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, 8, wall, plain_wall, "update + best_split of a 1e6-row "
            "stream", "[9]")
    return launches


def _qo_merge_row(cfg, batches, seed, dev):
    """Phase 3: the Chan-merge kernel at the first reduce level of the
    D=4 sync -- shards 0-1 against shards 2-3, their (T, M) table axes
    folded -- on the deltas after 8 DP batches and one more local step."""
    import torch
    from repro_torch.kernels import qo_merge
    from repro_torch.train import sharding as sh
    init, upd, _, _ = sh.build_data_parallel_reference(cfg, DP_SHARDS,
                                                       DP_SYNC, device=dev)
    st = init(seed)
    for Xb, yb in batches[:WARM_BATCHES + 1]:
        st, _ = upd(st, Xb, yb)
    delta, half = st["delta"], DP_SHARDS // 2
    fold = lambda a: a.reshape((-1, F, C))
    side = lambda sl: [fold(delta["ao_y"][k][sl]) for k in
                       ("n", "mean", "m2")] + [fold(delta["ao_sum_x"][sl])]
    planes = side(slice(0, half)) + side(slice(half, DP_SHARDS))
    out_k = qo_merge.merge_kernel(*planes)
    out_p = qo_merge.merge_plain(*planes)
    for name, a, b in zip(("n", "mean", "m2", "sum_x"), out_k, out_p):
        if not torch.equal(a, b):
            raise AssertionError(f"qo_merge: {name} differs from the plain "
                                 f"version")
    err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    E = planes[0].numel()
    bound, by = _bound(12 * 4 * E, 14 * E)
    occupied = int((planes[0] > 0).sum() + (planes[4] > 0).sum())
    print(f"[3] qo_merge: 2 x ({planes[0].shape[0]}, {F}, {C}) tables, "
          f"{occupied} occupied cells of {2 * E}, bitwise equal to the "
          f"plain version", flush=True)
    row = dict(
        name="qo_merge", route="cuda", source="src/repro_torch/csrc/qo_merge.cu",
        replaces="src/repro/kernels/qo_merge.py:83", max_abs_err=err,
        ms=_time_ms(lambda: qo_merge.merge_kernel(*planes)),
        plain_ms=_time_ms(lambda: qo_merge.merge_plain(*planes)),
        bound_ms=bound, bound_by=by, library_ms=None)
    return row


def _same(a, b, what):
    """Bitwise equality of two nested dicts/lists of tensors."""
    import torch
    if isinstance(a, dict):
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{what}/{i}")
    elif torch.is_tensor(a):
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    elif a != b:
        raise AssertionError(f"{what} differs: {a} != {b}")


def _dp_path(cfg, batches, shards, seed, dev, tag, kernels, n_nccl=8):
    """Phase 10 for one configuration: DP training through the reference
    with the counts reset, then the rerun, window, snapshot and one-rank
    NCCL checks.  Returns the launch counts of the main run."""
    import datetime
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import serve as sv
    from repro_torch.kernels import _build
    from repro_torch.train import sharding as sh

    def run(n_shards=shards, batches=batches, on_sync=None):
        init, upd, _, pred = sh.build_data_parallel_reference(
            cfg, n_shards, DP_SYNC, on_sync, device=dev)
        st, mse = init(seed), []
        for Xb, yb in batches:
            st, aux = upd(st, Xb, yb)
            if aux is not None:
                mse.append(float(aux["member_mse"].mean()))
        return st, mse, pred

    fired = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    state, mse, pred = run(on_sync=lambda f, step, aux: fired.append(step))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n = len(batches)
    n_syncs = n // DP_SYNC
    print(f"{tag} member MSE at the syncs: "
          + " ".join(f"{m:.4f}" for m in mse))
    print(f"{tag} nodes per tree: "
          f"{state['forest']['trees']['n_nodes'].tolist()}")
    print(f"{tag} {n} global batches of {B} rows over {shards} shards in "
          f"{secs:.3f} s: {n * B / secs:.0f} rows/s; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    print(f"{tag} kernels {json.dumps(launches)}", flush=True)
    for name, want in kernels.items():
        if (want is None and launches[name] <= 0) or \
                (want is not None and launches[name] != want):
            raise AssertionError(f"{name}: {launches[name]} launches on the "
                                 f"DP path, expected "
                                 f"{'> 0' if want is None else want}")
    if fired != list(range(DP_SYNC, n + 1, DP_SYNC)) or len(mse) != n_syncs:
        raise AssertionError(f"on_sync fired at {fired}")
    if not (np.isfinite(mse).all() and mse[-1] < mse[0]):
        raise AssertionError(f"DP member MSE did not fall: {mse}")
    if not bool((state["forest"]["trees"]["n_nodes"] > 1).all()):
        raise AssertionError("a DP tree never split")

    again, mse2, _ = run()
    _same(state, again, "DP rerun")
    if mse != mse2:
        raise AssertionError("DP rerun MSE trace differs")
    del again
    print(f"{tag} rerun from the same seed: bitwise-equal state", flush=True)

    init, upd, win, _ = sh.build_data_parallel_reference(cfg, shards,
                                                         DP_SYNC, device=dev)
    st_w, st_p = init(seed), init(seed)
    for i in range(0, min(n, 4), DP_SYNC):
        window = batches[i:i + DP_SYNC]
        st_w, _ = win(st_w, torch.stack([Xb for Xb, _ in window]),
                      torch.stack([yb for _, yb in window]))
        for Xb, yb in window:
            st_p, _ = upd(st_p, Xb, yb)
        _same(st_w, st_p, f"window at batch {i}")
    del st_w, st_p
    print(f"{tag} update_window (S={DP_SYNC}) equals {DP_SYNC} update "
          f"calls bitwise", flush=True)

    Xs, _ = batches[-1]
    snap = sv.freeze(state["forest"], device=dev)
    if not torch.equal(sv.predict_snapshot(snap, Xs, device=dev),
                       pred(state, Xs)):
        raise AssertionError("DP snapshot differs from live predict")
    print(f"{tag} snapshot at step {state['step']} (depth {snap.depth}): "
          f"equals live predict bitwise", flush=True)
    del state

    tmp = tempfile.mkdtemp(prefix="dp_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        init_d, upd_d, _, _ = sh.build_data_parallel_forest(
            cfg, sync_every=DP_SYNC, device=dev)
        init_r, upd_r, _, _ = sh.build_data_parallel_reference(
            cfg, 1, DP_SYNC, device=dev)
        st_d, st_r = init_d(seed), init_r(seed)
        for Xb, yb in batches[:n_nccl]:
            st_d, aux_d = upd_d(st_d, Xb, yb)
            st_r, aux_r = upd_r(st_r, Xb, yb)
            if (aux_d is None) != (aux_r is None):
                raise AssertionError("NCCL builder syncs at other steps")
            if aux_d is not None:
                _same(st_d, st_r, f"NCCL builder at step {st_d['step']}")
                _same(aux_d, aux_r, f"NCCL aux at step {st_d['step']}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{tag} build_data_parallel_forest (one-rank NCCL group) equals "
          f"the one-shard reference bitwise over {n_nccl} batches",
          flush=True)
    return launches


def _dp_profile(cfg, batches, seed, dev):
    """Phase 11: where the time of a DP global batch goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import sharding as sh
    init, upd, _, _ = sh.build_data_parallel_reference(cfg, DP_SHARDS,
                                                       DP_SYNC, device=dev)

    def warm():
        st = init(seed)
        for Xb, yb in batches[:WARM_BATCHES]:
            st, _ = upd(st, Xb, yb)
        torch.cuda.synchronize()
        return st

    window = batches[WARM_BATCHES:2 * WARM_BATCHES]
    st = warm()
    local, sync = [], []
    for Xb, yb in window:
        t0 = time.perf_counter()
        st, aux = upd(st, Xb, yb)
        torch.cuda.synchronize()
        (local if aux is None else sync).append(time.perf_counter() - t0)
    plain_wall = sum(local) + sum(sync)
    local_ms = statistics.mean(local) * 1e3
    print(f"[11] {len(window)} global batches ({len(sync)} syncs): "
          f"{plain_wall / len(window) * 1e3:.3f} ms a global batch; a local "
          f"step {local_ms:.3f} ms, a syncing step "
          f"{statistics.mean(sync) * 1e3:.3f} ms, so "
          f"{statistics.mean(sync) * 1e3 - local_ms:.3f} ms a sync",
          flush=True)
    st = warm()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for Xb, yb in window:
            st, _ = upd(st, Xb, yb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, len(window), wall, plain_wall,
            f"DP global batches (D = {DP_SHARDS})", "[11]")


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
    scfg = fr.ForestConfig(
        tree=ht.HTRConfig(n_features=F, max_nodes=M, n_bins=C,
                          grace_period=200, max_depth=DEPTH,
                          observer_backend="sketch", sketch_k=KS),
        n_trees=T, lam=6.0, subspace=0.7)
    sbatches = [(torch.exp(Xb), yb) for Xb, yb in batches]

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
    ty_r, tsx_r = tables()
    rows_k = qo_update_leaves.sort_rows(gl, T * M)
    qo_update_leaves.absorb_kernel(ty_k, tsx_k, radius, origin, gl, Xk, yk, w,
                                   rows_k)
    qo_update_leaves.absorb_kernel(ty_r, tsx_r, radius, origin, gl, Xk, yk, w,
                                   rows_k)
    _tables_equal((ty_k, tsx_k), (ty_r, tsx_r), "qo_update_leaves")
    del ty_r, tsx_r
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
            *scratch_k, radius, origin, gl, Xk, yk, w,
            qo_update_leaves.sort_rows(gl, T * M))),
        plain_ms=_time_ms(lambda: qo_update_leaves.absorb_plain(
            *scratch_p, radius, origin, gl, Xk, yk, w)),
        bound_ms=bound, bound_by=by, library_ms=None))
    dev_ms = _device_ms(lambda: qo_update_leaves.absorb_kernel(
        *scratch_k, radius, origin, gl, Xk, yk, w, rows_k))
    print(f"[3] qo_update_leaves: n exact, {touched} leaves touched, "
          f"max abs err {err:.3g}, rerun bitwise equal; device "
          f"{dev_ms:.4f} ms a launch (bound {bound:.5f} ms)", flush=True)
    _absorb_first_batch(cfg, batches, args.seed, dev)

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
    rows.append(_sketch_compact_row(scfg, sbatches, args.seed, dev))
    rows.extend(_qo_rows(args.seed, dev))
    rows.append(_qo_merge_row(cfg, batches, args.seed, dev))

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
    for name in ("qo_route", "qo_update_leaves", "qo_query_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if not (np.isfinite(mse).all() and mse[-1] < mse[0]):
        raise AssertionError(f"prequential forest_mse did not fall: {mse}")

    # ---- 5. determinism ---------------------------------------------------
    again, mse2 = stream()
    _same(state, again, "rerun")
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

    # ---- 8. the sketch forest ---------------------------------------------
    sketch_launches = _sketch_forest(scfg, sbatches, args.seed, dev)
    _profile(scfg, sbatches, args.seed, dev, tag="[8]")

    # ---- 9. the single-table QO observer ----------------------------------
    qo_launches = _paper_grid(args.seed, dev)

    # ---- 10. data-parallel training ---------------------------------------
    dp_launches = _dp_path(
        cfg, batches, DP_SHARDS, args.seed, dev, "[10]",
        {"qo_merge": 3 * STREAM_BATCHES // DP_SYNC, "qo_route": None,
         "qo_update_leaves": None, "qo_query_batched": None})
    _dp_path(scfg, sbatches[:WARM_BATCHES], DP_SKETCH_SHARDS, args.seed, dev,
             "[10 sketch]", {"qo_merge": 0, "qo_update_leaves": 0,
                             "sketch_compact": None, "qo_route": None,
                             "qo_query_batched": None}, n_nccl=4)

    # ---- 11. where the DP time goes ---------------------------------------
    _dp_profile(cfg, batches, args.seed, dev)

    # launches from the phase whose path runs each kernel
    for row in rows:
        row["launches"] = {"sketch_compact": sketch_launches,
                           "qo_update": qo_launches,
                           "qo_query": qo_launches,
                           "qo_merge": dp_launches}.get(
                               row["name"], launches)[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
