#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Seven paths at full width, each fatal on failure:

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
  2 batches;
* ``engine_t16_m1023_f16_c64``: the first forest trained and served at
  once by the serving engine, under injected faults and on threads;
* ``aos_n1e5``: the paper's attribute observers (E-BST, TE-BST with 3
  decimals, QO at r = 0.01, sigma/2 and sigma/3; the reference's
  ``benchmarks/aos.py``) on the 18 §5.1 streams at n = 100,000 and on one
  stream at n = 10^3..10^6;
* the LM scaffolding: qwen3-8b served unreduced and trained at full
  width (4 layers) with the QO monitor, the ``Trainer`` killed and
  resumed, and the other nine architectures at full width;
* the LM's multi-device layer: the same training step over a one-rank
  NCCL ``DeviceMesh`` (DTensor parameters, optimizer state and batch),
  and the dry-run of two production cells on a fake 256-rank mesh.

Phases:

1. the card's name and power limit (nvidia-smi);
2. build the ten CUDA sources from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once) into ``build/kernels/``, and the latency
   probes ``tools_torch/chase.cu`` beside them (a dependent load in global
   and in shared memory, a dependent observe and merge);
3. per kernel, at the shapes its path gives it (the forests after 8
   learned batches, one table absorbing a 1e6-row stream, the first reduce
   level of the D=4 sync after 8 DP batches): kernel vs its
   plain PyTorch version on the card (ids and counts exact; other
   statistics, merits and thresholds within 1e-4 relative with an
   absolute floor of 1e-4 -- for the single table, relative to each bin's
   sum of |terms| and to the table's variance, since sums of 1e6 mixed-sign
   terms cancel -- identical -inf patterns, a threshold differing only at
   a near-tie; the Chan merge bitwise), and both timed (median of
   CUDA-event-timed repeats); the route as the learn path calls it
   (``ops.forest_route`` on the (T, M) arrays, bounded by max_depth) one
   launch and no other device op a call, and again on the trees padded to
   M = 16,383 nodes (records read from global memory), the same ids; the
   single-table query rerun bitwise; both absorbs run twice and the runs
   compared bitwise, the forest absorb also on a fresh forest's first batch (every
   row in one of the 16 roots, 4,096 rows a leaf: several pieces a leaf),
   the single-table absorb also with all 1e6 rows in one bin; the sketch
   compaction (sort, rank and reduce fused) on the sketch forest's merge,
   one launch and no other device op a call, rerun bitwise, and the whole
   compaction stage timed beside the unfused stage's record; the target
   statistics kernel (``leaf_stats``) on the step's sort and on a root
   holding its tree's whole batch, one launch and no other device op a
   call, rerun bitwise, n exact against the plain version; the drift
   test (``drift_test``) at T = 10 and T = 64 members, one launch and no
   other device op a call, a planted member swapped, bitwise equal to the
   plain version and to a rerun, its device time no less than its bound;
   the batched
   query on the QO forest's attempt set and on the sketch forest's
   (C = K = 16), rerun bitwise; both E-BST kernels (insert and query)
   bitwise against their plain versions on a §5.1 stream of 5,000 rows as
   E-BST and as TE-BST, with duplicates, with NaN / +-inf / -0.0, past
   capacity and with constant targets, and against the single-thread
   oracle kernels on sorted and reversed streams (chains) and on 50,000
   rows (a tree beyond the insert's shared-memory part), each rerun
   bitwise and each call one launch, timed beside the oracle kernels with
   the walk's serial latency bound and the new design's bound;
4. QO forest end to end: 32 batches through ``forest.update`` with the
   launch counts set to 0 just before and read just after; every kernel
   of the path must have run;
5. determinism: the same seed again gives a bitwise-equal state;
6. serving: ``freeze`` + ``predict_snapshot`` of an 8192-row request equals
   the live ``forest.predict`` bit for bit;
7. where the time goes: 8 mid-growth steps (after 8 warm-up batches)
   timed plain and under torch.profiler, printing the device-busy share,
   the port's kernels, the launches and host syncs a step, the top
   device kernels and host operations, and
   the tables each split query covered with its byte bound (for both
   forests);
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
    operations;
12. the serving engine (``engine_t16_m1023_f16_c64``: the first forest
    behind ``core/engine.py``, ``EngineConfig(sync_every=4, ckpt_every=1,
    max_queue_rows=8192, max_batch_rows=2048)``, a ``Checkpointer`` with
    keep=3 under a temporary directory, the stream indexed by step, the
    requests ``bursty_arrivals(96, base_rows=256, burst_factor=8,
    burst_every=10, burst_len=2, base_gap_s=0.02, seed=3)``), with the
    counts reset: stepped under faults (a ``Kill`` one step past a
    publish, a ``Corrupt`` publish with a NaN threshold, ``Drop`` faults until
    the staleness flag trips, a request larger than the queue), every
    admitted ticket equal to ``predict_snapshot`` of its version bitwise,
    the recovered trainer rewound to the checkpoint step and, replayed,
    bitwise equal to an uninterrupted engine (generator state and every
    QO table), the counters equal to the scenario's; then the open loop on
    threads (sustained rows/s, p50/p99 latency, sheds, publishes, snapshot
    age); then its costs: ``serve_once`` against a bare
    ``predict_snapshot`` of 2048 rows taken in turns, freeze + validate +
    publish, the pre-step copy of the state, and a blocking ``save`` and
    ``restore_latest`` of the whole state (ms, GB/s);
13. sharded, in a one-rank NCCL group: ``build_sharded_forest`` over 8
    batches equal to ``forest.update`` bitwise (state and ``forest_mse``),
    ``build_sharded_serving`` of 8192 rows equal to ``predict_snapshot``,
    ``sketch.all_merge`` of a C = 1024 table absorbed from 10^6 rows equal
    to the table;
14. the attribute observers (``aos_n1e5``) with the counts reset: for each
    stream and observer the merit and its ratio to the exhaustive best,
    the elements stored, observe and query ms (CUDA events), |thr -
    thr_E-BST|, and for the E-BSTs the nodes visited and ns a node, the
    query's ns a node, and both latency bounds (the serial walk's, this
    design's) from the probes; E-BST within 1e-3 of the exhaustive merit,
    TE-BST smaller than E-BST, every QO ratio at least 0.9 (0.85 at r =
    sigma/2, whose reference value on uniform/0/cub is 0.8809); E-BST
    within 1e-2 where the targets' kappa^2 exceeds 100; E-BST and TE-BST
    at 10^5 rows of normal/0/lin bitwise equal to the single-thread oracle
    kernels; then the quickstart stream (QO r = 0.01 within 0.1 of E-BST's
    threshold);
15. the multi-target QO (10^6 rows, T = 3, C = 1024) against its CPU copy
    within 1e-4; QO telemetry over 10,000 steps with one planted straggler
    and one planted loss spike, the alerts there and nowhere else;
    ``sparsify_with_sketch`` on one qwen3-8b block's gradients (~193 M f32)
    beside ``torch.kthvalue``; the oracle engine on the first forest over
    8 batches: nodes per tree equal to the kernel path's, held-out MSE
    within 1 %, no kernel of the port launched;
16. the perf layer (``repro_torch.perf``): ``tune.tune`` at the QO
    forest's full width (T=16, M=1023, F=16, C=64, B=4096) for the
    forest families and at K=16 for the sketch families, every candidate
    of every grid bitwise equal to the defaults before it is timed, one
    line a family (candidates, the default's and the winner's device us
    of the kernel the knobs steer, the race's spread, the winner's
    params); the cache saved to a temporary file, reloaded,
    keyed by the card's name and installed; phase 7's 8-step window rerun
    with the table installed, trees and tables bitwise equal to the
    untuned run, ms a step and device busy beside phase 7's; ``op_costs``
    of one ``forest.update`` step (flops, bytes, the floor of that work)
    beside its device time; one ``profile.trace`` of a step, parsed, holding each
    kernel the step launched; ``python -m repro_torch.perf.tune --smoke``
    in a subprocess, exit 0.  Phase 16 runs in a process of its own:
    after phase 12's engine threads, ``torch.profiler`` records no device
    activity in this one.
17. LM serving (``repro_torch.models``), unreduced qwen3-8b (36 layers,
    d 4096, GQA 32/8, hd 128, vocab 151,936; 8.19e9 float32 parameters
    drawn from ``--seed``), bf16 compute: prefill B=4 x S=1024, then 32
    decode steps (tokens/s, ms a step, peak memory); in float32 (TF32
    off) a 256-token prompt, 128 tokens prefilled and 128 decoded
    teacher-forced, each position's logits within 1e-3 of max |logit| of
    the cache-free forward's; the same in bf16 (the gap and the argmax
    agreement printed); the port's chunked attention beside
    ``F.scaled_dot_product_attention`` at the prefill shape (recorded);
18. LM training: (a) qwen3-8b at full width cut to 4 layers (2.02e9
    parameters), 24 steps of B=8 x S=512 through ``build_train_step``
    with the QO monitor and the loop's ``observe(step_time=)``, the
    launch counts reset just before: the loss falls, ``qo_update``
    launches at least 72 times, the monitor equals a host copy fed the
    same scalars (counts equal, 1e-6); ms a step, tokens/s and MFU
    against the data sheet's 989 TFLOP/s; (b) the ``Trainer`` on reduced
    qwen3-8b (d 256, 2 layers), killed by SIGTERM after step 8 and
    resumed, against an uninterrupted 16-step run under
    ``torch.use_deterministic_algorithms`` (bitwise, or within 2e-4 with
    the op that warned named), ``publish_fn`` at each save, save and
    restore ms;
19. the nine other architectures at full width, depth cut to fit (2
    layers; grok-1 1; zamba2 one hybrid period of 6; whisper 2 + 2 with
    its 1500-frame encoder; h2o-danube a 4,608-token prefill past its
    4,096 window, so the ring cache wraps): ``lm_loss`` forward and
    backward (finite, MoE aux > 0), prefill and 8 decode steps; then
    every reduced architecture in float32 on the card and on the host
    with the same parameters and batch, loss, prefill logits and every
    gradient within 1e-4.  Phases 17-19 run in a process of their own
    (``CUBLAS_WORKSPACE_CONFIG`` set for 18(b)'s deterministic GEMMs).

20. the LM's multi-device layer, in a process of its own: (a) phase
    18a's configuration (qwen3-8b at full width, 4 layers, B=8 x S=512,
    bf16, the same weights and batches) through ``build_train_step(mesh=)``
    over a one-rank NCCL ``DeviceMesh`` (1 x 1, ("data", "model")) for 8
    steps, then one ``seq_parallel`` and one ``sharding_style="gather"``
    step: each step's loss and grad norm within 1e-4 of the unsharded
    step's (bitwise equality printed), ``qo_update`` 3 launches a step
    (loss, grad norm, step time), ms a step, tokens/s and MFU beside the
    unsharded step's in the same process; (b) the dry-run
    (``repro_torch.launch.dryrun``) of phi3-mini ``decode_32k`` and
    qwen3-8b ``train_4k`` on the fake 16x16 mesh, each a subprocess
    (the two at once, after (a)), status ok, the three roofline
    terms, ``useful_flops_ratio`` and seconds; (c) ``hlocost.analyze``
    over one sharded step, its flops against 6 N tokens.

Prints one JSON line of per-kernel numbers, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero, with
no result, when no GPU is visible.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

T, M, F, C, DEPTH, B = 16, 1023, 16, 64, 12, 4096
KS = 16                        # sketch centroids per (leaf, feature)
ROUTE_BIG_M = 16383            # nodes a tree: past a block's shared memory
QO_BINS, QO_ROWS = 1024, 1_000_000
DP_SHARDS, DP_SYNC, DP_SKETCH_SHARDS = 4, 2, 2
WARM_BATCHES, STREAM_BATCHES, SERVE_ROWS = 8, 32, 8192
TOL = 1e-4
# The compaction stage before its fusion (cat, sort, gathers, cumsum, ids,
# then a reduce kernel) at phase 3's shape, ms a call and device ms:
# ``sketch.merge_planes`` of the tree before the fused kernel, timed as
# phase 3 times it, NVIDIA H100 80GB HBM3, 700 W.
PARENT_STAGE_MS = (3.2984, 3.2929)


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
    """Device time of one call of ``fn``, in ms: the profiler's kernel
    time over ``reps`` calls (``repro_torch.perf.profile.device_times``).
    If the profiler dropped all three of its windows, CUDA events around
    ``reps`` back-to-back calls give the stream's time a call instead (an
    upper bound: host gaps between the launches count), and a line says
    so."""
    import torch
    from repro_torch.perf import profile
    times = profile.device_times(fn, reps)
    if times:
        return sum(times.values())
    print(f"    the profiler dropped three windows: the next device time is "
          f"the CUDA-event time of {reps} back-to-back calls", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def forest_config(**tree):
    """The forests' configuration (``tree``: further ``HTRConfig`` fields)."""
    from repro_torch.core import forest as fr
    from repro_torch.core import hoeffding as ht
    return fr.ForestConfig(
        tree=ht.HTRConfig(n_features=F, max_nodes=M, n_bins=C,
                          grace_period=200, max_depth=DEPTH, **tree),
        n_trees=T, lam=6.0, subspace=0.7)


def stream_batches(seed, dev):
    """The forests' stream: STREAM_BATCHES (X, y) batches of B rows."""
    import torch
    from repro_torch.data import synth
    n_rows = STREAM_BATCHES * B
    X_all, y_all = synth.piecewise_regression(n_rows, F, seed=seed)
    return [(torch.as_tensor(X_all[i:i + B], device=dev),
             torch.as_tensor(y_all[i:i + B], device=dev))
            for i in range(0, n_rows, B)]


def _profile(cfg, batches, seed, dev, tag="[7]"):
    """Phase 7: where the time of a mid-growth learned batch goes.
    Returns the unprofiled ms a step and the device ms a step."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.core import forest as fr
    from repro_torch.kernels import qo_query_batched
    from repro_torch.perf import profile
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
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for Xb, yb in window:
            state, _ = fr.update(cfg, state, Xb, yb, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _report(prof, len(window), wall, plain_wall, "mid-growth steps",
                   tag)
    queried, left_out = _queried_tables(cfg, batches, seed, dev)
    slots = cfg.tree.observer_bins()
    tables = statistics.mean(queried)
    bound, _ = profile.bound(*qo_query_batched.cost(tables / F, F, slots))
    print(f"{tag} qo_query_batched: {len(queried)} launches of "
          f"{tables:.0f} tables of C={slots} on average "
          f"({min(queried)}-{max(queried)}), bound {bound:.5f} ms a launch"
          + (f" ({left_out} steps with a drift swap left out)"
             if left_out else ""), flush=True)
    return plain_wall / len(window) * 1e3, busy / len(window)


def _queried_tables(cfg, batches, seed, dev):
    """The tables each split query of the profiled window covers, read
    from an unprofiled replay of it (the steps are deterministic): a leaf
    attempted when its grace count plus the weight the step brought it
    (the growth of its target count) reached the grace period.  A step
    that swaps a member for drift is left out (the fresh member no longer
    shows what its step brought).  Returns (tables a launch, steps left
    out); checked against the launch count."""
    from repro_torch.core import forest as fr
    from repro_torch.core import hoeffding as ht
    from repro_torch.kernels import _build
    state = fr.init_forest(cfg, seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    queried, left_out = [], 0
    launches = _build.LAUNCHES["qo_query_batched"]
    for Xb, yb in batches[WARM_BATCHES:2 * WARM_BATCHES]:
        t = state["trees"]
        before = {k: t[k].clone() for k in ("is_leaf", "seen_since_attempt",
                                            "depth", "n_nodes")}
        n0 = t["ystats"]["n"].clone()
        state, aux = fr.update(cfg, state, Xb, yb, device=dev)
        if bool(aux["drift"].any()):
            left_out += 1
            continue
        before["seen_since_attempt"] = before["seen_since_attempt"] \
            + (state["trees"]["ystats"]["n"] - n0)
        k = int((ht.attempt_mask(cfg.tree, before)
                 & (before["n_nodes"][:, None] + 1 < M)).sum())
        if k:
            queried.append(k * F)
    ran = _build.LAUNCHES["qo_query_batched"] - launches
    if not queried or not len(queried) <= ran <= len(queried) + left_out:
        raise AssertionError(f"split queries: {ran} launches, the replay "
                             f"read {len(queried)} attempt sets and left "
                             f"{left_out} steps out")
    return queried, left_out


def _report(prof, n, wall, plain_wall, what, tag):
    """Print a profiled window: wall times, device-busy share, the port's
    kernels, the top device kernels and the top host operations.  Returns
    the window's device-busy ms."""
    from repro_torch.perf import profile
    ev = prof.key_averages()
    kernels = profile.device_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3  # ms
    print(f"{tag} {n} {what}: {plain_wall / n * 1e3:.3f} ms each "
          f"unprofiled; profiled {wall / n * 1e3:.3f} ms each with device "
          f"busy {busy / n:.3f} ms ({busy / (wall * 1e3):.1%} of wall)")
    calls = {}
    for e in kernels:
        key = e.key[5:] if e.key.startswith("void ") else e.key
        if key.startswith(("qo_", "sketch_")):
            name = key.split('(')[0]
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
    host = {e.key: e.count for e in ev}
    print(f"{tag} host: {host.get('cudaLaunchKernel', 0) / n:.1f} "
          f"cudaLaunchKernel and "
          f"{host.get('cudaStreamSynchronize', 0) / n:.1f} "
          f"cudaStreamSynchronize each", flush=True)
    print(f"{tag} top device kernels (ms each, calls each):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}")
    print(f"{tag} top operations by host time (ms each, calls each):")
    for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"    {e.self_cpu_time_total / 1e3 / n:8.4f}  "
              f"{e.count / n:6.1f}  {e.key[:100]}", flush=True)
    return busy


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


def _route_row(trees, Xk):
    """Phase 3: the route as the learn path calls it (``ops.forest_route``
    on the (T, M) arrays, bounded by max_depth) is one launch and no other
    device op; its ids against the plain version; the same trees padded
    with unreachable leaves to M = ROUTE_BIG_M (records past a block's
    shared memory: read from global memory) give the same ids.  Returns
    the kernel's row and ids."""
    import torch
    from repro_torch.kernels import _build, qo_route
    from repro_torch.kernels import ops as kops
    from repro_torch.perf import profile
    arrays = [trees[k] for k in ("feature", "threshold", "child", "is_leaf")]
    call = lambda: kops.forest_route(*arrays, Xk, depth=DEPTH)
    before = _build.LAUNCHES["qo_route"]
    ops, calls = _device_kernels(call)
    if _build.LAUNCHES["qo_route"] != before + calls or len(ops) != 1:
        raise AssertionError(f"qo_route: a call ran {ops} and "
                             f"{_build.LAUNCHES['qo_route'] - before} "
                             f"launches, not the kernel alone")
    ids = call()
    if not torch.equal(ids, qo_route.route_plain(*arrays, Xk, DEPTH)):
        raise AssertionError("qo_route: leaf ids differ from the plain "
                             "version")
    pad = ROUTE_BIG_M - M
    big = [torch.cat([a, torch.full((T, pad) + a.shape[2:], fill,
                                    dtype=a.dtype, device=a.device)], 1)
           for a, fill in zip(arrays, (0, 0.0, -1, True))]
    if not torch.equal(kops.forest_route(*big, Xk, depth=DEPTH), ids):
        raise AssertionError(f"qo_route: the trees padded to M = "
                             f"{ROUTE_BIG_M} route elsewhere")
    # the nodes the trees have allocated (the slots past n_nodes are never
    # reached) and the plies the rows actually walked
    nodes = int(trees["n_nodes"].sum())
    plies = int(torch.gather(trees["depth"], 1, ids.long()).sum())
    bound, by = profile.bound(*qo_route.cost(T, M, B, F, DEPTH, nodes=nodes,
                                             walked=plies))
    row = dict(
        name="qo_route", route="cuda",
        source="src/repro_torch/csrc/qo_route.cu",
        replaces="src/repro/kernels/qo_route.py:151", max_abs_err=0.0,
        ms=_time_ms(call),
        plain_ms=_time_ms(lambda: qo_route.route_plain(*arrays, Xk, DEPTH)),
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"[3] qo_route: one launch and no other device op a call "
          f"({ops[0][:40]}), ids exact under the max_depth bound "
          f"({DEPTH}; deepest leaf {int(trees['depth'].max())}, {nodes} "
          f"nodes allocated), and at "
          f"M = {ROUTE_BIG_M} (global-memory records); the call "
          f"{row['ms']:.4f} ms, device {_device_ms(call):.4f} ms "
          f"(bound {bound:.6f} ms)", flush=True)
    return row, ids


def _sketch_inputs(scfg, sbatches, seed, dev):
    """The sketch forest after 8 learned batches, absorbing the next one:
    its trees, the batch's folded leaf ids ``gl``, weights ``w`` and
    targets ``yk``, and the two (T*M*F, K) plane sets its compaction
    merges (``old``: the tables, ``new``: the batch's pre-sketch)."""
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.core import hoeffding as ht
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import ops as kops
    state = fr.init_forest(scfg, seed, device=dev)
    for Xb, yb in sbatches[:WARM_BATCHES]:
        state, _ = fr.update(scfg, state, Xb, yb, device=dev)
    trees = state["trees"]
    Xk, yk = sbatches[WARM_BATCHES]
    leaf = kops.forest_route(trees["feature"], trees["threshold"],
                             trees["child"], trees["is_leaf"], Xk,
                             depth=scfg.tree.max_depth)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    w = torch.randint(0, 7, (T * B,), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32)
    gl = (torch.arange(T, device=dev, dtype=torch.int32)[:, None] * M
          + leaf).reshape(-1)
    flat = lambda a: a.reshape(-1, KS).contiguous()
    old = [flat(trees["ao_y"][k]) for k in ("n", "mean", "m2")] \
        + [flat(trees["ao_sum_x"])]
    new = [flat(a) for a in sk.from_batch_planes(gl, Xk, yk, w, T * M, KS)]
    return dict(trees=trees, gl=gl, w=w, yk=yk, old=old, new=new)


def _device_kernels(fn):
    """Names of the device operations one call of ``fn`` runs, and how many
    calls that took (no warm-up call: the caller counts these calls'
    launches; a window the profiler dropped is profiled again, so a call
    can be made more than once)."""
    from repro_torch.perf import profile
    calls = []
    ops = profile.device_times(lambda: calls.append(fn()), reps=1,
                               warm=False)
    return list(ops), len(calls)


def _sketch_compact_row(sin):
    """Phase 3: the fused compaction kernel (sort, rank, reduce) against
    ``compact_plain`` on the sketch forest's merge, and the whole stage
    timed beside the unfused one's record.  Returns the kernel's row and
    output."""
    import torch
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import _build, sketch_compact
    from repro_torch.perf import profile
    old, new = sin["old"], sin["new"]
    before = _build.LAUNCHES["sketch_compact"]
    ops, calls = _device_kernels(
        lambda: sketch_compact.compact_kernel(old, KS, new))
    if _build.LAUNCHES["sketch_compact"] != before + calls or len(ops) != 1:
        raise AssertionError(f"sketch_compact: a call ran {ops} and "
                             f"{_build.LAUNCHES['sketch_compact'] - before} "
                             f"launches, not the kernel alone")
    out_k = sketch_compact.compact_kernel(old, KS, new)
    out_p = sketch_compact.compact_plain(old, KS, new)
    if not torch.equal(out_k[0], out_p[0]):
        raise AssertionError("sketch_compact: n differs from the plain "
                             "version")
    err = max(_close(a, b, f"sketch_compact {name}") for a, b, name in
              zip(out_k[1:], out_p[1:], ("mean", "m2", "sum_x")))
    if not all(torch.equal(a, b) for a, b in
               zip(out_k, sketch_compact.compact_kernel(old, KS, new))):
        raise AssertionError("sketch_compact: a rerun differs")
    R, J = old[0].shape[0], 2 * KS
    bound, by = profile.bound(*sketch_compact.cost(R, J, KS))
    fn = lambda: sketch_compact.compact_kernel(old, KS, new)
    row = dict(
        name="sketch_compact", route="cuda",
        source="src/repro_torch/csrc/sketch_compact.cu",
        replaces="src/repro/kernels/sketch_compact.py:110",
        max_abs_err=err, ms=_time_ms(fn),
        plain_ms=_time_ms(lambda: sketch_compact.compact_plain(old, KS,
                                                               new)),
        bound_ms=bound, bound_by=by, library_ms=None)
    dev_ms = _device_ms(fn)
    # the whole compaction stage of a sketch step, as the main path calls it
    stage = lambda: sk.merge_planes(*old, *new)
    stage_ms, stage_dev = _time_ms(stage), _device_ms(stage)
    print(f"[3] sketch_compact: R={R} rows, J={J} -> K={KS}, one launch "
          f"and no other device op a call ({ops[0][:40]}), n exact, max abs "
          f"err {err:.3g}, rerun bitwise equal; device {dev_ms:.4f} ms a "
          f"launch = {bound / dev_ms:.1%} of its {bound:.5f} ms bound",
          flush=True)
    print(f"[3] compaction stage (sketch.merge_planes): {stage_ms:.4f} ms a "
          f"call, device {stage_dev:.4f} ms; before the fusion (cat, sort, "
          f"gathers, cumsum, ids and a reduce kernel), timed the same "
          f"way on that tree: "
          f"{PARENT_STAGE_MS[0]} ms a call, device {PARENT_STAGE_MS[1]} ms "
          f"(NVIDIA H100 80GB HBM3, 700 W)", flush=True)
    return row, out_k


def _leaf_stats_row(trees, gl, yk, w, what):
    """Phase 3: the target statistics kernel (``kernels/leaf_stats.py``)
    on the step's sort of the folded ids ``gl``: one launch and no other
    device op a call, no id flagged, a rerun bitwise, n and seen exact and
    mean, M2 within TOL of the plain version (today's composition); the
    call and the plain version timed, the kernel's device time against
    its bound.  Returns the kernel's row."""
    import torch
    from repro_torch.kernels import _build, leaf_stats, qo_update_leaves
    from repro_torch.perf import profile
    T_, M_ = trees["feature"].shape
    N, R, B_ = T_ * M_, gl.shape[0], yk.shape[0]
    rows = qo_update_leaves.sort_rows(gl, N)
    bad = torch.ones(1, dtype=torch.bool, device=gl.device)

    def fresh():
        return ({k: v.reshape(-1).clone() for k, v in
                 trees["ystats"].items()},
                trees["seen_since_attempt"].reshape(-1).clone())

    def kernel(args):
        return leaf_stats.leaf_stats_kernel(*args, yk, w, rows, bad)

    k0, k1, k2 = fresh(), fresh(), fresh()
    before = _build.LAUNCHES["leaf_stats"]
    # the profiled calls merge into k0 (more than once if a window drops)
    ops, calls = _device_kernels(lambda: kernel(k0))
    if _build.LAUNCHES["leaf_stats"] != before + calls or len(ops) != 1 \
            or bool(bad):
        raise AssertionError(f"leaf_stats ({what}): a call ran {ops}, "
                             f"{_build.LAUNCHES['leaf_stats'] - before} "
                             f"launches, flag {bool(bad)}")
    del k0
    kernel(k1)
    kernel(k2)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip([*k1[0].values(), k1[1]],
                               [*k2[0].values(), k2[1]])):
        raise AssertionError(f"leaf_stats ({what}): a rerun differs")
    py, ps = leaf_stats.leaf_stats_plain(*fresh(), gl, yk, w, rows, bad)
    if not (torch.equal(k1[0]["n"], py["n"]) and torch.equal(k1[1], ps)):
        raise AssertionError(f"leaf_stats ({what}): n or seen differs from "
                             f"the plain version")
    err = max(_close(k1[0][k], py[k], f"leaf_stats ({what}) {k}")
              for k in ("mean", "m2"))
    bound, by = profile.bound(*leaf_stats.cost(N, R, B_))
    scratch_k, scratch_p = fresh(), fresh()
    row = dict(
        name="leaf_stats", route="cuda",
        source="src/repro_torch/csrc/leaf_stats.cu", replaces=None,
        max_abs_err=err, ms=_time_ms(lambda: kernel(scratch_k)),
        plain_ms=_time_ms(lambda: leaf_stats.leaf_stats_plain(
            *scratch_p, gl, yk, w, rows, bad)),
        bound_ms=bound, bound_by=by, library_ms=None,
        device_ms=_device_ms(lambda: kernel(scratch_k)))
    longest = int(rows[1].diff().max())
    print(f"[3] leaf_stats ({what}): {N} entries, {R} rows, longest run "
          f"{longest}: one launch and no other device op a call "
          f"({ops[0][:40]}), n and seen exact, max abs err {err:.3g}, rerun "
          f"bitwise equal; the call {row['ms']:.4f} ms, device "
          f"{row['device_ms']:.4f} ms (bound {bound:.6f} ms, {by}); the "
          f"plain version {row['plain_ms']:.4f} ms", flush=True)
    return row


def _drift_inputs(T_, seed, dev):
    """A drift test's inputs at ``T_`` members and B live rows, as a forest
    step holds them mid-stream: long windows of 8-10 batches, errors near
    their means, member 1 far above its bar (it swaps) and member 0 above
    its bar by less (it signals, and its window freezes)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(T_, generator=gen, device=dev)
    n, mean = u(8.0, 9.95), u(1.0, 3.0)
    m2 = (n - 1) * u(0.05, 0.2) ** 2
    ewma, mse = mean * u(0.98, 1.02), mean * u(0.98, 1.02)
    mse[0], mse[1] = 40.0, 80.0
    resets = torch.randint(0, 5, (T_,), generator=gen, device=dev,
                           dtype=torch.int32)
    wraw = torch.tensor(float(B), device=dev)
    return (mse, wraw, torch.clamp(wraw, min=1e-12),
            {"n": n, "mean": mean, "m2": m2}, ewma, resets)


def _drift_test_row(cfg, T_, seed, dev):
    """Phase 3: the drift test kernel (``kernels/drift_test.py``) at ``T_``
    members and B rows under ``cfg``'s drift constants: one launch and no
    other device op a call, member 1 alone swapped, ``flags[0]`` set and
    ``flags[1]`` left alone, the inputs unwritten, bitwise equal to a
    rerun and to the plain version (today's composition); the call and
    the plain version timed, the kernel's device time no less than its
    bound from ``drift_test.cost``.  Returns the kernel's row."""
    import torch
    from repro_torch.kernels import _build, drift_test
    from repro_torch.perf import profile
    args = _drift_inputs(T_, seed, dev)
    consts = dict(B=B, drift_alpha=cfg.drift_alpha,
                  drift_decay=cfg.drift_decay, drift_kappa=cfg.drift_kappa,
                  min_batches=cfg.drift_min_batches)
    inputs = lambda: [args[0], *args[3].values(), args[4], args[5]]
    before_in = [a.clone() for a in inputs()]
    flags = [torch.tensor([False, True], device=dev) for _ in range(3)]

    def kernel(f):
        return drift_test.drift_test_kernel(*args, f, **consts)

    def plain(f):
        return drift_test.drift_test_plain(*args, f, **consts)

    out = []
    before = _build.LAUNCHES["drift_test"]
    ops, calls = _device_kernels(lambda: out.append(kernel(flags[0])))
    if _build.LAUNCHES["drift_test"] != before + calls or len(ops) != 1:
        raise AssertionError(f"drift_test (T = {T_}): a call ran {ops} and "
                             f"{_build.LAUNCHES['drift_test'] - before} "
                             f"launches, not the kernel alone")
    names = ("drift", "n", "mean", "m2", "ewma", "resets")
    bits = lambda r: [r[0], *(r[1][k].view(torch.int32) for k in names[1:4]),
                      r[2].view(torch.int32), r[3]]
    k1, k2, p = bits(out[-1]), bits(kernel(flags[1])), bits(plain(flags[2]))
    for a, b, c, what in zip(k1, k2, p, names):
        if not torch.equal(a, b):
            raise AssertionError(f"drift_test (T = {T_}): a rerun differs "
                                 f"in {what}")
        if not torch.equal(a, c):
            raise AssertionError(f"drift_test (T = {T_}): {what} differs "
                                 f"from the plain version")
    swapped = k1[0].nonzero().flatten().tolist()
    if swapped != [1] or [f.tolist() for f in flags] != [[True, True]] * 3:
        raise AssertionError(f"drift_test (T = {T_}): swapped {swapped}, "
                             f"flags {[f.tolist() for f in flags]}")
    win = out[-1][1]
    if not all(torch.equal(win[k][0], args[3][k][0]) for k in win):
        raise AssertionError(f"drift_test (T = {T_}): member 0 signals and "
                             f"its window did not freeze")
    if not all(torch.equal(a, b) for a, b in zip(inputs(), before_in)):
        raise AssertionError(f"drift_test (T = {T_}): an input was written")
    bound, by = profile.bound(*drift_test.cost(T_))
    scratch = torch.zeros(1, dtype=torch.bool, device=dev)
    row = dict(
        name="drift_test", route="cuda",
        source="src/repro_torch/csrc/drift_test.cu", replaces=None,
        max_abs_err=0.0, ms=_time_ms(lambda: kernel(scratch)),
        plain_ms=_time_ms(lambda: plain(scratch)),
        bound_ms=bound, bound_by=by, library_ms=None,
        device_ms=_device_ms(lambda: kernel(scratch)))
    if row["device_ms"] < bound:
        raise AssertionError(f"drift_test (T = {T_}): device "
                             f"{row['device_ms']} ms under its bound "
                             f"{bound} ms: cost() counts too many bytes")
    print(f"[3] drift_test (T = {T_}, B = {B}): one launch and no other "
          f"device op a call ({ops[0][:40]}), member 1 swapped and member 0 "
          f"frozen, bitwise equal to the plain version and to a rerun; the "
          f"call {row['ms']:.4f} ms, device {row['device_ms']:.6f} ms "
          f"(bound {bound:.9f} ms, {by}, "
          f"{bound / row['device_ms']:.3%}); the plain version "
          f"{row['plain_ms']:.4f} ms", flush=True)
    return row


def _attempt_rows(cfg, trees, gl, yk, w):
    """int32 rows of the (T*M) folded leaves the main path would query
    after absorbing a batch of targets ``yk`` routed to ``gl`` with bagging
    weights ``w``."""
    import torch
    from repro_torch.core import hoeffding as ht
    from repro_torch.core import stats
    fold = lambda a: a.reshape((T * M,) + a.shape[2:])
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
    if qrows.numel() == 0:
        raise AssertionError("qo_query_batched: no leaf attempts a split")
    return qrows


def _query_row(ty, tsx, qrows, what, timed_plain):
    """Phase 3: the batched query kernel against the plain version on one
    attempt set (merit within TOL, a threshold differing only at a
    near-tie of the plain version's best, a bitwise rerun), timed.
    Returns the kernel's row (``plain_ms`` only if ``timed_plain``)."""
    import torch
    from repro_torch.kernels import qo_query_batched
    from repro_torch.perf import profile
    K, (_, Fq, Cq) = qrows.numel(), tsx.shape
    merit_k, thr_k = qo_query_batched.best_splits_kernel(ty, tsx, qrows)
    merit_p, thr_p = qo_query_batched.best_splits_plain(ty, tsx, qrows)
    err = _close(merit_k, merit_p, f"qo_query_batched ({what}) merit")
    # a threshold may only differ where the kernel's boundary ties the
    # plain version's best within tolerance (f32 order can flip a tie)
    flat = lambda a: a[qrows.long()].reshape(K * Fq, Cq)
    score, cand = qo_query_batched.query_scores_plain(
        flat(ty["n"]), flat(ty["mean"]), flat(ty["m2"]), flat(tsx))
    tk, tp = thr_k.reshape(-1), thr_p.reshape(-1)
    diff = ((tk - tp).abs() > TOL * tp.abs() + TOL).nonzero().reshape(-1)
    for i in diff.tolist():
        hit = (cand[i] == tk[i]).nonzero().reshape(-1)
        best = float(merit_p.reshape(-1)[i])
        if hit.numel() == 0 or abs(float(score[i, hit[0]]) - best) \
                > TOL * abs(best) + TOL:
            raise AssertionError(f"qo_query_batched ({what}): threshold of "
                                 f"table {i} is not a near-tie of the best "
                                 f"boundary")
    again = qo_query_batched.best_splits_kernel(ty, tsx, qrows)
    if not (torch.equal(merit_k, again[0]) and torch.equal(thr_k, again[1])):
        raise AssertionError(f"qo_query_batched ({what}): a rerun differs")
    bound, by = profile.bound(*qo_query_batched.cost(K, Fq, Cq))
    fn = lambda: qo_query_batched.best_splits_kernel(ty, tsx, qrows)
    row = dict(
        name="qo_query_batched", route="cuda",
        source="src/repro_torch/csrc/qo_query_batched.cu",
        replaces="src/repro/kernels/qo_query_batched.py:151",
        max_abs_err=err, ms=_time_ms(fn),
        plain_ms=_time_ms(lambda: qo_query_batched.best_splits_plain(
            ty, tsx, qrows)) if timed_plain else None,
        bound_ms=bound, bound_by=by, library_ms=None)
    print(f"[3] qo_query_batched ({what}): K={K} tables x {Fq} features, "
          f"C={Cq}, {len(diff)} near-tie thresholds, max abs err {err:.3g}, "
          f"rerun bitwise equal; {row['ms']:.4f} ms a call, device "
          f"{_device_ms(fn):.4f} ms (bound {bound:.5f} ms)", flush=True)
    return row


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
    from repro_torch.perf import profile
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
    bound, by = profile.bound(*qo_update.cost(QO_ROWS, QO_BINS))
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
    bound, by = profile.bound(*qo_query.cost(QO_BINS))
    rows.append(dict(
        name="qo_query", route="cuda", source="src/repro_torch/csrc/qo_query.cu",
        replaces="src/repro/kernels/qo_query.py:121", max_abs_err=err,
        ms=_time_ms(lambda: qo_query.best_kernel(*planes)),
        plain_ms=_time_ms(lambda: qo_query.best_plain(*planes)),
        bound_ms=bound, bound_by=by, library_ms=None))
    again = qo_query.best_kernel(*planes)
    if not all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(k, again)):
        raise AssertionError("qo_query: a rerun differs")
    print(f"[3] qo_query: C={QO_BINS}, {int((planes[0] > 0).sum())} occupied "
          f"bins, threshold {float(k[2][0]):.5f}, max abs err {err:.3g}, "
          f"rerun bitwise equal; {rows[-1]['ms']:.4f} ms a call, device "
          f"{_device_ms(lambda: qo_query.best_kernel(*planes)):.4f} ms "
          f"(bound {bound:.7f} ms)", flush=True)
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
    from repro_torch.perf import profile
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
    bound, by = profile.bound(*qo_merge.cost(E))
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


ENGINE = dict(sync_every=4, ckpt_every=1, max_queue_rows=8192,
              max_batch_rows=2048)
ARRIVALS = dict(base_rows=256, burst_factor=8, burst_every=10, burst_len=2,
                base_gap_s=0.02, seed=3)
N_REQUESTS, ENGINE_KEEP, SHARDED_BATCHES = 96, 3, 8


def _sync():
    import torch
    torch.cuda.synchronize()


def _check_path_launches(tag):
    from repro_torch.kernels import _build
    launches = dict(_build.LAUNCHES)
    print(f"{tag} kernels {json.dumps(launches)}", flush=True)
    for name in ("qo_route", "qo_update_leaves", "qo_query_batched"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the {tag} path")


def _engine_faults(cfg, batches, pool, seed, dev, tmp):
    """Phase 12, stepped: the engine under a Kill, a Corrupt publish,
    Drops and an oversize request; every admitted ticket against
    ``predict_snapshot`` of its version, the recovered trainer against an
    uninterrupted engine.  Returns the faulted engine."""
    import dataclasses
    import torch
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.core import engine as eng
    from repro_torch.core import faults as fl
    from repro_torch.core import forest as fr
    from repro_torch.core import serve as sv
    from repro_torch.kernels import _build

    stream = lambda step: batches[step] if step < len(batches) else None
    ecfg = eng.EngineConfig(**ENGINE)
    sched = fl.bursty_arrivals(N_REQUESTS, **ARRIVALS)
    inj = fl.FaultInjector()

    def nan_threshold(s):
        t, m = [int(i[0]) for i in torch.nonzero(~s.is_leaf, as_tuple=True)]
        thr = s.threshold.clone()
        thr[t, m] = float("nan")
        return dataclasses.replace(s, threshold=thr)

    _sync()
    _build.reset_launches()
    e = eng.ServingEngine(cfg, fr.init_forest(cfg, seed, device=dev), stream,
                          cfg=ecfg, checkpointer=Checkpointer(
                              tmp, keep=ENGINE_KEEP),
                          injector=inj, device=dev)
    clean = eng.ServingEngine(cfg, fr.init_forest(cfg, seed, device=dev),
                              stream, cfg=ecfg, device=dev)
    checked, compared, k = 0, [], 0

    def serve_and_check():
        nonlocal checked
        while e.serve_once():
            pass
        for t in tickets[checked:]:
            if t.status == "done":
                want = sv.predict_snapshot(e.snapshot_for_version(t.version),
                                           t.X, device=dev).cpu().numpy()
                if not (want == t.result).all():
                    raise AssertionError(f"ticket of {t.rows} rows differs "
                                         f"from predict_snapshot of v"
                                         f"{t.version}")
            elif t.status != "shed":
                raise AssertionError(f"ticket left {t.status}")
        checked = len(tickets)

    # the trainer calls k: 0-3 learn steps 0-3 (publish v2 and a checkpoint
    # at step 4); 4 learns step 4; 5 is killed and rewinds to step 4
    # (publish v3); 6-9 replay to step 8 (v4); the publish at step 12 (call
    # 13) is corrupt, those at 16, 20 and 24 dropped, so the snapshot ages
    # past 3 windows at steps 21-23 and 25-27; 28 and 32 publish (v5, v6)
    tickets = []
    t0 = time.perf_counter()
    while True:
        if k == 4:
            inj.arm("trainer.step", fl.Kill(), after=1)
        if k == 10:
            inj.arm("publish", fl.Corrupt(nan_threshold))
            tickets.append(e.submit(pool[:ENGINE["max_queue_rows"] + 1]))
        if k == 14:
            inj.arm("publish", fl.Drop(), times=3)
        rows = sched[k % len(sched)][1]
        tickets.append(e.submit(pool[:rows]))
        if not e.train_once():
            break
        k += 1
        if k == 6 and (e._trainer_step, e._published.step) != (4, 4):
            raise AssertionError(f"the kill did not rewind to the "
                                 f"checkpoint at step 4: trainer step "
                                 f"{e._trainer_step}, published step "
                                 f"{e._published.step}")
        serve_and_check()
        while clean._trainer_step < e._trainer_step:
            clean.train_once()
        if clean._trainer_step == e._trainer_step in (8, len(batches)):
            _same(clean._state, e._state,
                  f"faulted engine at step {e._trainer_step}")
            compared.append(e._trainer_step)
    _sync()
    secs = time.perf_counter() - t0
    _check_path_launches("[12]")
    m = e.metrics()
    want = {"trainer_crashes": 1, "recoveries": 1, "rollbacks": 1,
            "publish_failures": 1, "publishes_dropped": 3, "publishes": 6,
            "shed_requests": 1, "shed_rows": ENGINE["max_queue_rows"] + 1,
            "stale_events": 6, "ckpt_failures": 0}
    got = {key: m[key] for key in want}
    if got != want or inj.fired("trainer.step") != 1 \
            or inj.fired("publish") != 4:
        raise AssertionError(f"counters {got}, expected {want}; fired "
                             f"{inj.log}")
    if compared != [8, len(batches)]:
        raise AssertionError(f"compared with the clean engine at {compared}")
    done = sum(t.status == "done" for t in tickets)
    print(f"[12] stepped under faults: {k} trainer calls in {secs:.3f} s; "
          f"the kill rewound to step 4, the replay equals an uninterrupted "
          f"engine bitwise at steps {compared} (rng and every QO table); "
          f"{done} admitted tickets equal predict_snapshot of their "
          f"version bitwise; counters {json.dumps(got)}; stale flag seen "
          f"{m['stale_events']} steps", flush=True)
    del clean
    return e


def _engine_open_loop(cfg, batches, pool, seed, dev, tmp, smi):
    """Phase 12, threaded: the open-loop arrivals racing the trainer."""
    import numpy as np
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.core import engine as eng
    from repro_torch.core import faults as fl
    from repro_torch.core import forest as fr

    stream = lambda step: batches[step] if step < len(batches) else None
    e = eng.ServingEngine(cfg, fr.init_forest(cfg, seed, device=dev), stream,
                          cfg=eng.EngineConfig(**ENGINE),
                          checkpointer=Checkpointer(tmp, keep=ENGINE_KEEP),
                          device=dev)
    e.submit(pool[:ENGINE["max_batch_rows"]])       # warm, off the books
    e.serve_once()
    m0 = e.metrics()
    sched = fl.bursty_arrivals(N_REQUESTS, **ARRIVALS)
    e.start()
    try:
        t0 = time.perf_counter()
        tickets = []
        for gap, rows in sched:
            if gap:
                time.sleep(gap)
            tickets.append(e.submit(pool[:rows]))
        for t in tickets:
            if not t.wait(timeout=120):
                raise AssertionError("an admitted ticket was never served")
        wall = time.perf_counter() - t0
        learned = e._trainer_step
    finally:
        e.stop(drain=True, timeout=120)
    m = e.metrics()
    served = m["served_rows"] - m0["served_rows"]
    lat = np.array([t.latency_s for t in tickets if t.status == "done"])
    if any(t.status not in ("done", "shed") for t in tickets) or \
            served + m["shed_rows"] != sum(t.rows for t in tickets):
        raise AssertionError("the open loop left admitted tickets unserved")
    print(f"[12] open loop ({smi}): {len(tickets)} requests in {wall:.3f} s: "
          f"{served / wall:.0f} rows/s sustained, latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms; shed {m['shed_requests']} "
          f"requests, {m['shed_rows']} rows; "
          f"{m['serve_batches'] - m0['serve_batches']} serve "
          f"batches; the trainer learned {learned} batches in the window "
          f"({learned * B / wall:.0f} rows/s), {m['publishes']} "
          f"publishes by the stop; snapshot age at stop {m['age_steps']} "
          f"steps, "
          f"{m['age_s'] * 1e3:.1f} ms", flush=True)


def _engine_costs(cfg, e, pool, dev, tmp, smi):
    """Phase 12, costs: serve_once vs a bare predict_snapshot in turns,
    freeze + validate + publish, the pre-step copy, save and restore."""
    import torch
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.core import engine as eng
    from repro_torch.core import serve as sv

    state = e._state
    rows = ENGINE["max_batch_rows"]
    Xq = pool[:rows]
    ec = eng.ServingEngine(cfg, state, lambda step: None,
                           cfg=eng.EngineConfig(**ENGINE), device=dev)
    snap = ec.snapshot_for_version(1)

    def eng_once():
        t = ec.submit(Xq)
        ec.serve_once()
        return t.result

    def bare_once():
        return sv.predict_snapshot(snap, Xq, device=dev).cpu().numpy()

    if not (eng_once() == bare_once()).all():
        raise AssertionError("serve_once differs from predict_snapshot")
    t_eng, t_bare = [], []
    for _ in range(150):
        for fn, times in ((eng_once, t_eng), (bare_once, t_bare)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    print(f"[12] serve_once of {rows} rows ({smi}): min "
          f"{min(t_eng) * 1e3:.4f} ms, median "
          f"{statistics.median(t_eng) * 1e3:.4f} ms; bare predict_snapshot "
          f"min {min(t_bare) * 1e3:.4f} ms, median "
          f"{statistics.median(t_bare) * 1e3:.4f} ms; frac_of_bare "
          f"{min(t_bare) / min(t_eng):.3f} (min), "
          f"{statistics.median(t_bare) / statistics.median(t_eng):.3f} "
          f"(median)", flush=True)

    def timed(fn, reps):
        out = []
        for _ in range(reps):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    t_freeze = timed(lambda: sv.freeze(state, device=dev), 5)
    t_valid = timed(lambda: sv.validate_snapshot(snap), 5)
    t_pub = timed(ec.publish_from_state, 5)
    t_copy = timed(lambda: eng._clone(state), 10)
    print(f"[12] publish ({smi}): freeze {t_freeze:.3f} ms, validate "
          f"{t_valid:.3f} ms, freeze + validate + publish {t_pub:.3f} ms; "
          f"the pre-step copy of the state {t_copy:.3f} ms", flush=True)

    nbytes = sum(t.numel() * t.element_size() for t in _tensors(state))
    ck = Checkpointer(tmp, keep=ENGINE_KEEP)
    t_save = timed(lambda: ck.save(1000, state, blocking=True), 3)
    t_rest = timed(lambda: ck.restore_latest(state), 3)
    _same(state, ck.restore_latest(state), "restored engine state")
    print(f"[12] checkpoint of {nbytes / 1e6:.1f} MB ({smi}): blocking save "
          f"{t_save:.1f} ms ({nbytes / t_save / 1e6:.3f} GB/s), "
          f"restore_latest {t_rest:.1f} ms ({nbytes / t_rest / 1e6:.3f} "
          f"GB/s), restored bitwise", flush=True)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _engine_phase(cfg, batches, seed, dev, smi):
    """Phase 12: the serving engine at full width."""
    import shutil
    import tempfile
    from repro_torch.data import synth
    pool, _ = synth.piecewise_regression(ENGINE["max_queue_rows"] + 1, F,
                                         seed=seed + 12)
    tmp = tempfile.mkdtemp(prefix="engine_ckpt_")
    try:
        e = _engine_faults(cfg, batches, pool, seed, dev,
                           os.path.join(tmp, "faults"))
        _engine_open_loop(cfg, batches, pool, seed, dev,
                          os.path.join(tmp, "open"), smi)
        _engine_costs(cfg, e, pool, dev, os.path.join(tmp, "costs"), smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sharded_phase(cfg, batches, seed, dev):
    """Phase 13: the tree-axis sharded forest, request-sharded serving and
    all_merge in a one-rank NCCL group, each against its unsharded call."""
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core import forest as fr
    from repro_torch.core import qo
    from repro_torch.core import serve as sv
    from repro_torch.core import sketch
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    from repro_torch.train import sharding as sh

    tmp = tempfile.mkdtemp(prefix="sharded_nccl_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        _sync()
        _build.reset_launches()
        sharded = sh.build_sharded_forest(cfg, device=dev)
        ref = fr.init_forest(cfg, seed, device=dev)
        shd = sharded.shard(ref)
        for i, (Xb, yb) in enumerate(batches[:SHARDED_BATCHES]):
            ref, aux_r = fr.update(cfg, ref, Xb, yb, device=dev)
            shd, aux_s = sharded.update(shd, Xb, yb)
            _same(ref, shd, f"sharded forest at batch {i}")
            _same(aux_r, aux_s, f"sharded aux at batch {i}")
        _sync()
        _check_path_launches("[13]")
        print(f"[13] build_sharded_forest (one-rank NCCL group) equals "
              f"forest.update bitwise over {SHARDED_BATCHES} batches, "
              f"forest_mse {float(aux_s['forest_mse']):.4f}", flush=True)
        snap = sv.freeze(ref, device=dev)
        Xs, _ = synth.piecewise_regression(SERVE_ROWS, F, seed=seed + 7)
        Xs = torch.as_tensor(Xs, device=dev)
        served = sh.build_sharded_serving(snap, device=dev)(snap, Xs)
        if not torch.equal(served, sv.predict_snapshot(snap, Xs,
                                                       device=dev)):
            raise AssertionError("sharded serving differs from "
                                 "predict_snapshot")
        print(f"[13] build_sharded_serving of {SERVE_ROWS} rows equals "
              f"predict_snapshot bitwise", flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 13)
        x = torch.randn(QO_ROWS, generator=gen, device=dev)
        y = 2.0 * (x > 0.3) + 0.1 * torch.randn(QO_ROWS, generator=gen,
                                                device=dev)
        radius, origin = qo.auto_radius(x[:10_000])
        table = qo.update(qo.init(QO_BINS, radius, origin, device=dev), x, y,
                          device=dev)
        merged = sketch.all_merge(table)
        _same(table, merged, "all_merge of one rank")
        print(f"[13] all_merge of a C={QO_BINS} table absorbed from "
              f"{QO_ROWS} rows equals the table bitwise", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


EBST_ROWS = 5000               # phase 3: one §5.1 stream
AO_ROWS = 100_000              # phase 14: the §5.1 grid
AO_SCALING = (1_000, 10_000, 100_000, 1_000_000)
AOS = ("ebst", "tebst", "qo_0.01", "qo_s2", "qo_s3")
MULTI_ROWS, MULTI_T, MULTI_C = 1_000_000, 3, 1024
MON_STEPS, MON_STRAGGLER, MON_SPIKE = 10_000, 6_000, 8_000
KEEP_FRAC, ORACLE_BATCHES = 0.05, 8
# the gradient leaves of one block of src/repro/configs/qwen3_8b.py
# (d_model 4096, 32 query and 8 key-value heads of 128, d_ff 12288)
QWEN3_8B_BLOCK = {
    "attn": {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
             "o": (4096, 4096)},
    "mlp": {"gate": (4096, 12288), "up": (4096, 12288),
            "down": (12288, 4096)},
    "norm": {"attn": (4096,), "mlp": (4096,)}}


def _start_probe():
    """Start nvcc on ``tools_torch/chase.cu`` (the latency probes, not
    kernels of the port) beside the port's builds.  Returns a function
    that waits for it and gives a :class:`_Probes` on a device."""
    from repro_torch.kernels import _build
    out = os.path.join(ROOT, "build", "probes", "chase.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
         os.path.join(ROOT, "tools_torch", "chase.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(dev):
        import ctypes
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on tools_torch/chase.cu:\n{log}")
        lib = ctypes.CDLL(out)
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        for name, args in (("chase_launch", [ptr, i64, ptr, ptr]),
                           ("chase_shared_launch",
                            [ptr, ctypes.c_int, i64, ptr, ptr]),
                           ("observe_chain_launch", [ptr, i64, ptr, ptr]),
                           ("merge_chain_launch",
                            [ptr, ptr, ptr, i64, ptr, ptr])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        return _Probes(lib, dev)
    return load


def _cycle(n, dev):
    """next[] of one random cycle through n int32 slots."""
    import torch
    perm = torch.randperm(n, device=dev)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    return nxt


def _ns_a_step(launch, steps):
    """ns a step of a one-thread chain: the second of two identical
    launches, CUDA events."""
    import torch
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = launch()
        end.record()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"latency probe: launch failed ({rc})")
    return start.elapsed_time(end) * 1e6 / steps


class _Probes:
    """The E-BST kernels' latency yardsticks (``tools_torch/chase.cu``),
    ns a dependent step of one thread: :meth:`l2` a load in global memory
    over a buffer of ``nbytes`` (the insert's walk below its cached top;
    the serial walk), ``shared`` a load in shared memory over the
    insert's cached top, ``observe`` and ``merge`` the statistics'
    (total's fold; a level of the query's context forest)."""

    STEPS = 200_000

    def __init__(self, lib, dev):
        import torch
        from repro_torch.kernels import ebst as kebst
        self.lib, self.dev = lib, dev
        out = torch.empty(3, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        n = kebst.SHARED_NODES * 4     # int32 slots of the cached top
        nxt = _cycle(n, dev)
        self.shared = _ns_a_step(lambda: lib.chase_shared_launch(
            nxt.data_ptr(), n, self.STEPS, out.data_ptr(), stream),
            self.STEPS)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        a = torch.randn(3, self.STEPS, generator=gen, device=dev)
        a[0] = a[0].abs() * 100.0      # counts
        a[2] = a[2].abs()              # M2
        self.observe = _ns_a_step(lambda: lib.observe_chain_launch(
            a[1].data_ptr(), self.STEPS, out.data_ptr(), stream), self.STEPS)
        self.merge = _ns_a_step(lambda: lib.merge_chain_launch(
            a[0].data_ptr(), a[1].data_ptr(), a[2].data_ptr(), self.STEPS,
            out.data_ptr(), stream), self.STEPS)

    def l2(self, nbytes):
        """ns a hop through a random cycle over ``nbytes`` of global
        memory (every hop a random cache line)."""
        import torch
        nxt = _cycle(max(nbytes // 4, 256), self.dev)
        out = torch.empty(1, dtype=torch.int32, device=self.dev)
        stream = torch.cuda.current_stream(self.dev).cuda_stream
        return _ns_a_step(lambda: self.lib.chase_launch(
            nxt.data_ptr(), self.STEPS, out.data_ptr(), stream), self.STEPS)


def _ebst_copy(t, dev):
    return {k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dev, copy=True))
            for k, v in t.items()}


def _bits_same(a, b):
    """Equal values, NaN where NaN, signs of zeros too."""
    import torch
    a, b = a.cpu(), b.cpu()
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan], b[~nan]) and torch.equal(torch.signbit(a[~nan]),
                                          torch.signbit(b[~nan]))


def _ebst_same(k, p, what):
    """Bitwise equality of two E-BSTs (structure, le, total)."""
    for key in ("key", "left", "right", "size"):
        if not _bits_same(k[key], p[key]):
            raise AssertionError(f"{what}: {key} differs")
    for part in ("le", "total"):
        for key in ("n", "mean", "m2"):
            if not _bits_same(k[part][key], p[part][key]):
                raise AssertionError(f"{what}: {part}/{key} differs")


def _ebst_walk(t, xs):
    """Counts of inserting ``xs`` into an empty tree, from the tree it
    made (valid while no row hit capacity): nodes visited (a row that
    made node v passed its depth(v) ancestors, a duplicate of v's key
    depth(v) + 1 nodes), those of them among the insert's shared-memory
    nodes (index < ``kernels.ebst.SHARED_NODES``), the tree's levels and
    its context forest's (1 + the most right turns on a root path: the
    query's chain of merges)."""
    import torch
    from repro_torch.kernels import ebst as kebst
    size = int(t["size"])
    dev = xs.device
    left, right = t["left"][:size].long(), t["right"][:size].long()
    zeros = lambda: torch.zeros(size, dtype=torch.long, device=dev)
    depth, cached_above, turns = zeros(), zeros(), zeros()
    frontier, d = torch.zeros(1, dtype=torch.long, device=dev), 0
    while frontier.numel():
        depth[frontier] = d
        cached = cached_above[frontier] + (frontier < kebst.SHARED_NODES)
        kids = []
        for side, turn in ((left, 0), (right, 1)):
            c = side[frontier]
            has = c >= 0
            cached_above[c[has]] = cached[has]
            turns[c[has]] = turns[frontier[has]] + turn
            kids.append(c[has])
        frontier, d = torch.cat(kids), d + 1
    dec = int(t["decimals"])
    if dec >= 0:
        scale, inv = kebst._scales(dec, dev)
        xs = torch.round(xs * scale) * inv
    keys, order = torch.sort(t["key"][:size])
    node = order[torch.searchsorted(keys, xs)]
    own = torch.arange(size, device=dev) < kebst.SHARED_NODES
    visits = int((depth[node] + 1).sum()) - size
    shared = int((cached_above[node] + own[node]).sum()) - int(own.sum())
    return dict(visits=visits, shared_visits=shared, levels=d,
                context_levels=int(turns.max()) + 1)


def _ebst_bounds(t, xs, probes):
    """The E-BST kernels' latency bounds in ms for the tree ``t`` made by
    inserting ``xs``.  The serial walk: nodes visited x the global
    dependent-load latency at the tree's bytes (insert), two such loads
    a node (query).  This design: insert max(shared-memory visits x the
    shared chase + the others x the global one, N dependent observes:
    total's fold); query max(one pass over the nodes' bytes at 3.35 TB/s,
    the context forest's levels x one merge)."""
    from repro_torch.kernels import ebst as kebst
    from repro_torch.perf import profile
    w = _ebst_walk(t, xs)
    size = int(t["size"])
    lat = probes.l2(size * 24)
    walk = w["shared_visits"] * probes.shared \
        + (w["visits"] - w["shared_visits"]) * lat
    return dict(w, lat=lat, size=size,
                serial_insert=w["visits"] * lat * 1e-6,
                serial_query=size * 2 * lat * 1e-6,
                insert=max(walk, xs.shape[0] * probes.observe) * 1e-6,
                query=max(profile.bound(*kebst.query_cost(size))[0],
                          w["context_levels"] * probes.merge * 1e-6))


def _event_ms(fn):
    """(fn(), ms of the call on CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ebst_device_ms(fn, reps=10):
    """Device ms of one call: the profiler's time of the E-BST kernels
    (a call's packing of the total and its ``out > 0`` left out)."""
    from repro_torch.perf import profile
    times = profile.device_times(fn, reps)
    return sum(v for k, v in times.items() if "ebst" in k) or float("nan")


def _ebst_insert_ms(fresh, insert, xt, yt, reps):
    """Median CUDA-event ms of ``insert`` into a fresh copy of ``fresh``."""
    import torch
    times = []
    for _ in range(reps):
        t = _ebst_copy(fresh, xt.device)
        torch.cuda.synchronize()
        times.append(_event_ms(lambda: insert(t, xt, yt))[1])
    return statistics.median(times)


EBST_BIG = 50_000              # phase 3: a tree beyond the shared top


def _ebst_rows(seed, dev, probes):
    """Phase 3: both E-BST entry points on the card, bitwise, each call one
    launch, each rerun bitwise: against their plain versions (on host
    copies of the same inputs) on a §5.1 stream of EBST_ROWS rows as E-BST
    and as TE-BST (3 decimals), with duplicates, with NaN / +-inf / -0.0,
    past capacity and with constant targets; against the single-thread
    oracle kernels (the plain walk would take minutes) on the sorted and
    the reversed stream (chains) and on EBST_BIG rows.  E-BST and TE-BST
    are timed beside the oracle kernels and the plain versions, with both
    latency bounds.  Returns the two kernels' rows."""
    import numpy as np
    import torch
    from repro_torch.core import ebst
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    from repro_torch.kernels import ebst as kebst
    from repro_torch.perf import profile
    n = EBST_ROWS
    x, y = synth.generate(synth.SynthConfig("normal", 0, "lin", 0.1, n, seed))
    xb, yb = synth.generate(synth.SynthConfig("normal", 0, "lin", 0.1,
                                              EBST_BIG, seed + 5))
    rng = np.random.default_rng(seed + 3)
    ext = x.copy()
    for v, count in ((np.nan, 50), (np.inf, 25), (-np.inf, 25), (-0.0, 25)):
        ext[rng.integers(0, n, count)] = v
    chain = np.sort(x)
    cases = [("E-BST", -1, x, y, n, "plain"), ("TE-BST", 3, x, y, n, "plain"),
             ("duplicates", -1, np.round(x, 1).astype(np.float32), y, n,
              "plain"),
             ("NaN/inf", -1, ext, y, n, "plain"),
             ("past capacity", -1, x, y, n // 4, "plain"),
             ("constant y", -1, x, np.full(n, 2.5, np.float32), n, "plain"),
             ("sorted chain", -1, chain, y, n, "serial"),
             ("reversed chain", -1, chain[::-1].copy(), y, n, "serial"),
             ("beyond shared memory", -1, xb, yb, EBST_BIG, "serial")]
    out = {}
    for what, dec, xs, ys, cap, oracle in cases:
        xt, yt = torch.as_tensor(xs, device=dev), torch.as_tensor(ys,
                                                                   device=dev)
        rows = xt.shape[0]
        fresh = ebst.init(cap, dec, device=dev)
        k = _ebst_copy(fresh, dev)
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        kebst.insert_kernel(k, xt, yt)
        sk = kebst.query_kernel(k)
        torch.cuda.synchronize()
        for name in ("ebst_insert", "ebst_query"):
            if _build.LAUNCHES[name] != before[name] + 1:
                raise AssertionError(f"{name} ({what}): "
                                     f"{_build.LAUNCHES[name] - before[name]}"
                                     f" launches, expected 1")
        if oracle == "plain":
            p = _ebst_copy(fresh, "cpu")
            t0 = time.perf_counter()
            kebst.insert_plain(p, xt.cpu(), yt.cpu())
            plain_ins = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            sp = kebst.query_plain(p)
            plain_q = (time.perf_counter() - t0) * 1e3
        else:
            p = _ebst_copy(fresh, dev)
            kebst.insert_serial(p, xt, yt)
            sp = kebst.query_serial(p)
        _ebst_same(k, p, f"ebst_insert ({what})")
        if not all(_bits_same(a, b) for a, b in zip(sk, sp)):
            raise AssertionError(f"ebst_query ({what}): threshold, merit or "
                                 f"valid differs from the {oracle} version")
        r = _ebst_copy(fresh, dev)
        kebst.insert_kernel(r, xt, yt)
        _ebst_same(r, k, f"ebst_insert ({what}) rerun")
        if not all(_bits_same(a, b) for a, b in zip(kebst.query_kernel(r),
                                                    sk)):
            raise AssertionError(f"ebst_query ({what}): a rerun differs")
        print(f"[3] ebst ({what}, {rows} rows, capacity {cap}): "
              f"{int(k['size'])} nodes; structure, le, total, threshold "
              f"{float(sk[0]):+.5f} and merit {float(sk[1]):.6f} bitwise "
              f"equal to the {oracle} version; rerun bitwise; one launch "
              f"each", flush=True)
        if what not in ("E-BST", "TE-BST"):
            continue
        ins_ms = _ebst_insert_ms(fresh, kebst.insert_kernel, xt, yt, 10)
        serial_ins = _ebst_insert_ms(fresh, kebst.insert_serial, xt, yt, 5)
        q_ms = _time_ms(lambda: kebst.query_kernel(k))
        q_dev = _ebst_device_ms(lambda: kebst.query_kernel(k))
        serial_q = _time_ms(lambda: kebst.query_serial(k), reps=5, warm=1)
        b = _ebst_bounds(k, xt, probes)
        out[what] = dict(b, ins_ms=ins_ms, q_ms=q_ms, q_dev=q_dev,
                         serial_ins=serial_ins, serial_q=serial_q,
                         plain_ins=plain_ins, plain_q=plain_q, cap=cap)
        print(f"[3] ebst ({what}): insert {ins_ms:.4f} ms (serial kernel "
              f"{serial_ins:.4f}; {b['visits']} nodes visited, "
              f"{b['shared_visits']} of them in shared memory, "
              f"{ins_ms * 1e6 / b['visits']:.1f} ns a node; bounds: serial "
              f"{b['serial_insert']:.4f} ms, this design "
              f"{b['insert']:.4f} ms), query {q_ms:.4f} ms a call, "
              f"{q_dev:.4f} ms on the device (serial kernel {serial_q:.4f};"
              f" {b['size']} nodes, {q_dev * 1e6 / b['size']:.1f} ns a node,"
              f" {b['context_levels']} context levels; bounds: serial "
              f"{b['serial_query']:.4f} ms, this design {b['query']:.5f} "
              f"ms); plain versions {plain_ins:.1f} / {plain_q:.1f} ms on "
              f"the host", flush=True)
    print(f"[3] latency probes: global {out['E-BST']['lat']:.1f} ns a hop "
          f"over {out['E-BST']['size'] * 24} B, shared {probes.shared:.1f} "
          f"ns, observe {probes.observe:.1f} ns, merge {probes.merge:.1f} "
          f"ns", flush=True)
    e = out["E-BST"]
    ins_bound, ins_by = profile.bound(*kebst.insert_cost(n, e["cap"],
                                                         e["visits"]))
    q_bound, q_by = profile.bound(*kebst.query_cost(e["size"]))
    note = ("no Pallas kernel exists: the reference lowers it to one "
            "lax.while_loop program")
    return [dict(name="ebst_insert", route="cuda",
                 source="src/repro_torch/csrc/ebst.cu",
                 replaces="src/repro/core/ebst.py:60", max_abs_err=0.0,
                 ms=e["ins_ms"], plain_ms=e["plain_ins"], bound_ms=ins_bound,
                 bound_by=ins_by, library_ms=None,
                 serial_kernel_ms=e["serial_ins"],
                 latency_bound_ms=e["serial_insert"],
                 design_bound_ms=e["insert"], note=note),
            dict(name="ebst_query", route="cuda",
                 source="src/repro_torch/csrc/ebst.cu",
                 replaces="src/repro/core/ebst.py:135", max_abs_err=0.0,
                 ms=e["q_ms"], device_ms=e["q_dev"], plain_ms=e["plain_q"],
                 bound_ms=q_bound, bound_by=q_by, library_ms=None,
                 serial_kernel_ms=e["serial_q"],
                 latency_bound_ms=e["serial_query"],
                 design_bound_ms=e["query"], note=note)]


def _make_qo(variant, x, dev):
    """The QO variants of the reference's ``benchmarks/aos.py::_make_qo``:
    r = 0.01 with the capacity sized to the data's span, or r = sigma/k."""
    import torch
    from repro_torch.core import qo
    sigma = float(torch.std(x, correction=0)) or 1.0
    mu = float(x.mean())
    if variant == "qo_0.01":
        span = float(x.max() - x.min()) + 1e-6
        need = int(span / 0.01) + 2
        cap = max(2048, 1 << (need - 1).bit_length())
        return qo.init(cap, radius=0.01, origin=mu, device=dev)
    k = 2.0 if variant == "qo_s2" else 3.0
    return qo.init(2048, radius=sigma / k, origin=mu, device=dev)


def _run_ao(name, x, y, dev, probes):
    """One attribute observer on one stream: merit, threshold, elements,
    observe and query ms (CUDA events), and for the E-BSTs the tree, its
    split, the nodes visited and both designs' latency bounds."""
    from repro_torch.core import ebst, qo
    if name in ("ebst", "tebst"):
        t0 = ebst.init(x.shape[0], 3 if name == "tebst" else -1, device=dev)
        t, obs_ms = _event_ms(lambda: ebst.update(t0, x, y, device=dev))
        s, q_ms = _event_ms(lambda: ebst.best_split(t, device=dev))
        elements = int(ebst.n_elements(t))
        extra = dict(_ebst_bounds(t, x, probes), tree=t, split=s)
    else:
        empty = _make_qo(name, x, dev)
        t, obs_ms = _event_ms(lambda: qo.update(empty, x, y, device=dev))
        s, q_ms = _event_ms(lambda: qo.best_split(t, device=dev))
        elements = int(qo.n_slots(t))
        extra = {}
    return dict(merit=float(s.merit), thr=float(s.threshold),
                valid=bool(s.valid), elements=elements, obs_ms=obs_ms,
                q_ms=q_ms, **extra)


def _ao_line(tag, what, name, r, exact, thr_e):
    line = (f"{tag} {what:22s} {name:7s} merit {r['merit']:.6g} ratio "
            f"{r['merit'] / exact:.5f} elements {r['elements']:7d} observe "
            f"{r['obs_ms']:9.3f} ms query {r['q_ms']:8.3f} ms |thr - "
            f"thr_E-BST| {abs(r['thr'] - thr_e):.5f}")
    if "visits" in r:
        line += (f" visited {r['visits']} ({r['obs_ms'] * 1e6 / r['visits']:.1f}"
                 f" ns a node; insert bounds {r['serial_insert']:.3f} ms "
                 f"serial, {r['insert']:.3f} ms this design) query "
                 f"{r['q_ms'] * 1e6 / r['size']:.1f} ns a node (bounds "
                 f"{r['serial_query']:.3f} ms serial, {r['query']:.4f} ms "
                 f"this design; {r['context_levels']} context levels); "
                 f"latency {r['lat']:.1f} ns")
    print(line, flush=True)


def _ebst_oracle(r, x, y, what):
    """An observer's tree and split bitwise equal to the single-thread
    oracle kernels' on the same stream."""
    from repro_torch.core import ebst
    from repro_torch.kernels import ebst as kebst
    t, s = r["tree"], r["split"]
    o = ebst.init(t["key"].shape[0], int(t["decimals"]), device=x.device)
    kebst.insert_serial(o, x, y)
    _ebst_same(t, o, f"{what} against the serial oracle")
    if not all(_bits_same(a, b) for a, b in zip(
            (s.threshold, s.merit, s.valid), kebst.query_serial(o))):
        raise AssertionError(f"{what}: the split differs from the serial "
                             f"oracle's")
    print(f"[14] {what}: tree and split bitwise equal to the single-thread "
          f"oracle kernels'", flush=True)


def _conditioning(y):
    """1 + mean^2 / var of the targets: the condition number (squared) of
    their f32 mean / M2 algebra (Chan, Golub and LeVeque)."""
    y = y.double()
    return float(1.0 + y.mean() ** 2 / y.var())


#: The least merit ratio phase 14 takes from each QO variant.  The JAX
#: reference's own QO gives 0.8809 at r = sigma/2 on uniform/0/cub (7 bins
#: over the span of a cubic; ``tools_torch/aos_reference.py``), so that
#: variant is held to 0.85, the other two to phase 9's 0.9.
QO_MIN_RATIO = {"qo_0.01": 0.9, "qo_s2": 0.85, "qo_s3": 0.9}


def _check_aos(what, res, exact, kappa2):
    """E-BST within 1e-3 of the exhaustive merit (1e-2 where the targets'
    f32 statistics cannot resolve 1e-3: kappa^2 > 100), TE-BST smaller
    than E-BST, every QO ratio in [QO_MIN_RATIO, 1 + 1e-3]."""
    e, te = res["ebst"], res["tebst"]
    tol = 1e-3 if kappa2 <= 100.0 else 1e-2
    if not (e["valid"] and abs(e["merit"] / exact - 1.0) <= tol):
        raise AssertionError(f"{what}: E-BST merit {e['merit']} vs the "
                             f"exhaustive {exact} (kappa^2 {kappa2:.1f})")
    if not te["elements"] < e["elements"]:
        raise AssertionError(f"{what}: TE-BST stores {te['elements']}, "
                             f"E-BST {e['elements']}")
    for name, least in QO_MIN_RATIO.items():
        ratio = res[name]["merit"] / exact
        if not (res[name]["valid"] and least <= ratio <= 1.0 + 1e-3):
            raise AssertionError(f"{what}: {name} merit ratio {ratio}")


def _ao_phase(seed, dev, probes, smi):
    """Phase 14: the paper's attribute-observer comparison (the AOs of the
    reference's ``benchmarks/aos.py``) on the §5.1 grid at AO_ROWS rows,
    the per-row cost's growth on (normal, 0, lin), and the quickstart
    stream.  Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    grid = [synth.SynthConfig(dist, v, task, 0.1, AO_ROWS, seed)
            for dist in synth.DISTRIBUTIONS for v in range(3)
            for task in synth.TASKS]
    agg = {name: [] for name in AOS}
    print(f"[14] attribute observers ({smi}): merit, its ratio to the "
          f"exhaustive best, elements stored, observe and query ms (CUDA "
          f"events), |thr - thr_E-BST|", flush=True)
    for cfg in grid:
        what = f"{cfg.dist}/{cfg.variant}/{cfg.task}"
        x, y = _paper_stream(cfg, dev)
        exact, kappa2 = _exact_merit(x, y), _conditioning(y)
        res = {name: _run_ao(name, x, y, dev, probes) for name in AOS}
        print(f"[14] {what}: exhaustive merit {exact:.6g}, targets' "
              f"kappa^2 {kappa2:.1f}", flush=True)
        for name in AOS:
            _ao_line("[14]", what, name, res[name], exact, res["ebst"]["thr"])
            agg[name].append((res[name], exact, res["ebst"]["thr"]))
        _check_aos(what, res, exact, kappa2)
    print(f"[14] over the {len(grid)} streams of {AO_ROWS} rows (mean; "
          f"ratio min-max):", flush=True)
    for name in AOS:
        rs = agg[name]
        ratios = [r["merit"] / ex for r, ex, _ in rs]
        mean = lambda key: statistics.mean(r[key] for r, _, _ in rs)
        dthr = statistics.mean(abs(r["thr"] - te) for r, _, te in rs)
        print(f"[14]   {name:7s} ratio {statistics.mean(ratios):.5f} "
              f"({min(ratios):.5f}-{max(ratios):.5f}) elements "
              f"{mean('elements'):.0f} observe {mean('obs_ms'):.3f} ms "
              f"query {mean('q_ms'):.3f} ms |thr - thr_E-BST| {dthr:.5f}",
              flush=True)
    for n in AO_SCALING:
        cfg = synth.SynthConfig("normal", 0, "lin", 0.1, n, seed)
        x, y = _paper_stream(cfg, dev)
        exact = _exact_merit(x, y)
        res = {name: _run_ao(name, x, y, dev, probes) for name in AOS}
        for name in AOS:
            r = res[name]
            _ao_line("[14]", f"normal/0/lin n={n}", name, r, exact,
                     res["ebst"]["thr"])
            print(f"[14]     {name} observe {r['obs_ms'] * 1e6 / n:.1f} ns a "
                  f"row", flush=True)
        _check_aos(f"n={n}", res, exact, _conditioning(y))
        if n == AO_ROWS:
            for name in ("ebst", "tebst"):
                _ebst_oracle(res[name], x, y, f"normal/0/lin n={n} {name}")
    rng = np.random.default_rng(0)
    xq = rng.normal(0, 1, 20_000).astype(np.float32)
    yq = np.where(xq <= 0.3, 1.0, 6.0).astype(np.float32) + \
        0.1 * rng.normal(0, 1, 20_000).astype(np.float32)
    xq, yq = torch.as_tensor(xq, device=dev), torch.as_tensor(yq, device=dev)
    thr = {name: _run_ao(name, xq, yq, dev, probes)["thr"]
           for name in ("ebst", "qo_0.01")}
    gap = abs(thr["qo_0.01"] - thr["ebst"])
    print(f"[14] quickstart: E-BST {thr['ebst']:+.5f}, QO r=0.01 "
          f"{thr['qo_0.01']:+.5f}, |gap| {gap:.5f} (planted 0.3)", flush=True)
    if gap >= 0.1:
        raise AssertionError(f"quickstart: QO and E-BST thresholds {gap} "
                             f"apart")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[14] kernels {json.dumps(launches)}", flush=True)
    for name in ("ebst_insert", "ebst_query", "qo_update", "qo_query"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched in phase 14")
    return launches


def _multi_check(seed, dev):
    """Phase 15 (1): the multi-target QO on the card against its plain
    CPU copy."""
    import torch
    from repro_torch.core import multi
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 15)
    x = torch.randn(MULTI_ROWS, generator=gen, device=dev)
    noise = torch.randn((MULTI_ROWS, MULTI_T), generator=gen, device=dev)
    Y = torch.stack([(t + 1.0) * (x > 0.3 * t) for t in range(MULTI_T)], 1) \
        + 0.1 * noise
    r, o = 0.01, float(x.mean())
    empty = multi.init(MULTI_C, MULTI_T, r, o, device=dev)
    multi.best_split(multi.update(empty, x, Y, device=dev), device=dev)
    table, up_ms = _event_ms(lambda: multi.update(empty, x, Y, device=dev))
    split, q_ms = _event_ms(lambda: multi.best_split(table, device=dev))
    cpu = multi.update(multi.init(MULTI_C, MULTI_T, r, o, device="cpu"),
                       x.cpu(), Y.cpu(), device="cpu")
    csplit = multi.best_split(cpu, device="cpu")
    if not torch.equal(table["y"]["n"].cpu(), cpu["y"]["n"]):
        raise AssertionError("multi: counts differ from the CPU copy")
    ids = torch.clamp(torch.floor((x - o) / r).long() + MULTI_C // 2, 0,
                      MULTI_C - 1)
    absx = torch.zeros(MULTI_C, device=dev).index_add_(0, ids, x.abs())
    absy = torch.zeros((MULTI_C, MULTI_T), device=dev).index_add_(
        0, ids, Y.abs()) / torch.clamp(table["y"]["n"], min=1.0)
    err = max(_close(table["y"]["mean"], cpu["y"]["mean"].to(dev),
                     "multi mean", absy),
              _close(table["y"]["m2"], cpu["y"]["m2"].to(dev), "multi m2"),
              _close(table["sum_x"], cpu["sum_x"].to(dev), "multi sum_x",
                     absx))
    for a, b, what in ((split.merit, csplit.merit, "merit"),
                       (split.threshold, csplit.threshold, "threshold")):
        if abs(float(a) - float(b)) > TOL * abs(float(b)) + TOL:
            raise AssertionError(f"multi {what}: {float(a)} on the card, "
                                 f"{float(b)} on the CPU")
    if bool(split.valid) != bool(csplit.valid):
        raise AssertionError("multi: validity differs")
    print(f"[15] multi: {MULTI_ROWS} rows, T={MULTI_T} targets, C={MULTI_C} "
          f"bins ({int(multi.n_slots(table))} occupied): update "
          f"{up_ms:.3f} ms, best_split {q_ms:.3f} ms (second calls); "
          f"equal to the CPU copy "
          f"(counts exact, max abs err {err:.3g}), threshold "
          f"{float(split.threshold):+.5f} merit {float(split.merit):.5f}",
          flush=True)


def _monitor_check(seed, dev):
    """Phase 15 (2): QO telemetry over MON_STEPS synthetic steps, with one
    planted straggler and one planted loss spike; each step is checked
    before it is observed, the flags read once at the end."""
    import numpy as np
    import torch
    from repro_torch.train import monitor
    rng = np.random.default_rng(seed + 16)
    loss = (5.0 - 2e-4 * np.arange(MON_STEPS)
            + 0.02 * rng.normal(0, 1, MON_STEPS)).astype(np.float32)
    grad = (1.0 + 0.05 * rng.normal(0, 1, MON_STEPS)).astype(np.float32)
    # two step-time levels in separate bins: the p99 bin's prototype is
    # exactly 1.0, so only the planted straggler exceeds it
    step = np.where(rng.random(MON_STEPS) < 0.5, 0.9, 1.0).astype(np.float32)
    step[MON_STRAGGLER] = 5.0
    loss[MON_SPIKE] = 100.0
    lt, gt, st = (torch.as_tensor(a, device=dev) for a in (loss, grad, step))
    mon = monitor.init_monitor(device=dev)
    flags = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = 0.0
    for i in range(MON_STEPS):
        flags.append(torch.stack([monitor.is_straggler(mon, st[i]),
                                  monitor.loss_spike(mon, lt[i])]))
        t1 = time.perf_counter()
        mon = monitor.observe(mon, loss=lt[i], grad_norm=gt[i],
                              step_time=st[i])
        obs += time.perf_counter() - t1
    fired = torch.stack(flags).cpu().numpy()
    wall = time.perf_counter() - t0
    straggler = np.nonzero(fired[:, 0])[0].tolist()
    spike = np.nonzero(fired[:, 1])[0].tolist()
    s = monitor.summaries(mon)
    print(f"[15] monitor: {MON_STEPS} steps in {wall:.3f} s; observe "
          f"{obs / MON_STEPS * 1e6:.1f} us a step (3 signals, host time of "
          f"the calls); straggler alerts at {straggler}, loss-spike alerts "
          f"at {spike}; step_time p99 {float(s['step_time']['p99']):.4f}, "
          f"loss mean {float(s['loss']['mean']):.4f} std "
          f"{float(s['loss']['std']):.4f}", flush=True)
    if straggler != [MON_STRAGGLER] or spike != [MON_SPIKE]:
        raise AssertionError(f"monitor alerts at {straggler} and {spike}, "
                             f"planted {MON_STRAGGLER} and {MON_SPIKE}")
    if float(s["loss"]["count"]) != MON_STEPS:
        raise AssertionError("monitor: the loss table lost steps")


def _sparsify_check(seed, dev):
    """Phase 15 (3): sparsify_with_sketch on one qwen3-8b block's gradient
    leaves, beside the exact k-th magnitude."""
    import math
    import torch
    from repro_torch.optim import compress
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)

    def leaves(shapes):
        return {k: leaves(v) if isinstance(v, dict) else
                torch.randn(v, generator=gen, device=dev)
                for k, v in shapes.items()}

    def walk(tree):
        for v in tree.values():
            yield from walk(v) if isinstance(v, dict) else [v]

    grads = leaves(QWEN3_8B_BLOCK)
    tensors = list(walk(grads))
    n = sum(t.numel() for t in tensors)
    err = compress.init_error_state(grads)
    compress.sparsify_with_sketch(grads, err, keep_frac=KEEP_FRAC)  # warm
    (sparse, new_err, m), ms = _event_ms(lambda: compress.sparsify_with_sketch(
        grads, err, keep_frac=KEEP_FRAC))

    def kth():
        return [torch.kthvalue(t.abs().reshape(-1),
                               max(1, math.ceil((1 - KEEP_FRAC) * t.numel()))
                               ).values for t in tensors]
    kth()
    thr, kth_ms = _event_ms(kth)
    exact = sum(int((t.abs() >= v).sum()) for t, v in zip(tensors, thr)) / n
    ok = compress._map(lambda s, e, g: {"": bool(torch.equal(s + e, g))},
                       sparse, new_err, grads)
    bad = not all(walk(ok))
    density = float(m["density"])
    print(f"[15] sparsify_with_sketch: one qwen3-8b block, {len(tensors)} "
          f"leaves, {n} f32 elements: {ms:.3f} ms, density {density:.5f} "
          f"against keep_frac {KEEP_FRAC}; the exact k-th magnitude "
          f"(torch.kthvalue a leaf) {kth_ms:.3f} ms, its density "
          f"{exact:.5f}", flush=True)
    if bad or not 0.0 < density < 1.0:
        raise AssertionError(f"sparsify: g + e != sparse + new_e ({bad}) "
                             f"or density {density}")


def _oracle_check(batches, seed, dev):
    """Phase 15 (4): the oracle engine on the first forest from the same
    seed and draws as the kernel path: nodes per tree equal, held-out MSE
    within 1 %, no port kernel launched, a rerun bitwise equal."""
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.data import synth
    from repro_torch.kernels import _build
    Xs, ys = synth.piecewise_regression(SERVE_ROWS, F, seed=seed + 7)
    Xs, ys = torch.as_tensor(Xs, device=dev), torch.as_tensor(ys, device=dev)
    out = {}
    for backend in ("auto", "oracle", "oracle"):
        cfg = forest_config(split_backend=backend)
        st = fr.init_forest(cfg, seed, device=dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        for Xb, yb in batches[:ORACLE_BATCHES]:
            st, _ = fr.update(cfg, st, Xb, yb, device=dev)
        mse = float(((fr.predict(cfg, st, Xs, device=dev) - ys) ** 2).mean())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if backend in out:
            _same(out[backend][4], st, "the oracle engine's rerun")
        out[backend] = (st["trees"]["n_nodes"].tolist(), mse,
                        secs / ORACLE_BATCHES * 1e3, dict(_build.LAUNCHES),
                        st)
    (nk, mk, sk, _, _), (no, mo, so, lo, _) = out["auto"], out["oracle"]
    print(f"[15] oracle engine: {ORACLE_BATCHES} batches, {so:.1f} ms a step "
          f"(the kernel path {sk:.1f} ms); nodes per tree {no} (kernel path "
          f"{nk}); held-out MSE {mo:.5f} (kernel path {mk:.5f}); a rerun "
          f"bitwise equal; kernels {json.dumps(lo)}", flush=True)
    if any(lo.values()):
        raise AssertionError(f"a port kernel launched on the oracle path: "
                             f"{lo}")
    if no != nk or abs(mo - mk) > 0.01 * mk:
        raise AssertionError("the oracle engine's forest differs from the "
                             "kernel path's")


def _phase15(batches, seed, dev):
    """Phase 15: multi-target QO, QO telemetry, sketch sparsification and
    the oracle engine."""
    _multi_check(seed, dev)
    _monitor_check(seed, dev)
    _sparsify_check(seed, dev)
    _oracle_check(batches, seed, dev)

#: The kernels of a QO forest step: a substring of each one's device name,
#: by its launch count's name.
STEP_KERNELS = {"qo_route": "qo_route_kernel",
                "leaf_stats": "leaf_stats_kernel",
                "drift_test": "drift_test_kernel",
                "qo_update_leaves": "qo_update_leaves_pieces_kernel",
                "qo_query_batched": "qo_query_batched_kernel"}


def _window(cfg, batches, seed, dev):
    """Phase 7's window: a fresh forest, 8 warm-up batches, then 8 steps
    timed.  Returns (state, ms a step)."""
    import torch
    from repro_torch.core import forest as fr
    state = fr.init_forest(cfg, seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for Xb, yb in batches[WARM_BATCHES:2 * WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / WARM_BATCHES * 1e3


def _tuning_phase(cfg, batches, seed, dev, smi, phase7):
    """Phase 16: the perf layer on the card.  The tuner at phase 7's full
    width (and the sketch families at K = 16), every candidate through the
    identity gate; its cache saved, reloaded and installed; phase 7's
    window rerun tuned, bitwise equal to the untuned one; ``op_costs`` of
    a step beside its device time; a trace of a step holding each kernel
    the step launched; ``python -m repro_torch.perf.tune --smoke``."""
    import glob
    import tempfile
    import torch
    from repro_torch.core import forest as fr
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.perf import profile
    from repro_torch.perf import tune as ptune
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="tuning_")
    entries = ptune.tune(("forest_query", "forest_route", "forest_merge"),
                         "cuda", shapes=dict(T=T, M=M, F=F, C=C, B=B))
    entries.update(ptune.tune(("sketch_update", "sketch_merge"), "cuda",
                              shapes=dict(T=T, M=M, F=F, C=KS, B=B)))
    for key, e in sorted(entries.items()):
        print(f"[16] {key}: {e['n_candidates']} candidates, every one "
              f"bitwise equal to the defaults; the steered kernel's device "
              f"time {e['default_us']:.2f} us a call at the defaults, "
              f"{e['us']:.2f} us for the winner {e['params']} (a winner must "
              f"beat the defaults by more than the race's spread, "
              f"{e['spread_us']:.2f} us; whole call: host "
              f"{e['default_host_us']:.1f} / {e['host_us']:.1f} us, events "
              f"{e['default_event_us']:.1f} / {e['event_us']:.1f} us; {smi})",
              flush=True)
    path = ptune.save_cache(entries, os.path.join(tmp, "tuning.json"))
    loaded = ptune.load_cache(path)
    if loaded != json.loads(json.dumps(entries)):
        raise AssertionError("the tuning cache did not reload as written")
    kind = torch.cuda.get_device_name(0)
    if not all(k.startswith(kind + "|") for k in loaded):
        raise AssertionError(f"a cache key is not keyed by {kind!r}")
    installed = ptune.install(loaded)
    if len(installed) != len(entries):
        raise AssertionError("install dropped this card's entries")
    moved = {k: v for k, v in installed.items()
             if v != kops.DEFAULT_PARAMS[k[0]]}
    print(f"[16] cache {len(loaded)} entries keyed {kind!r}, reloaded and "
          f"installed; off the defaults: {moved or 'none'}", flush=True)

    # phase 7's window, tuned against untuned
    table = kops.get_tuning()
    kops.set_tuning({})
    untuned, ms_u = _window(cfg, batches, seed, dev)
    kops.set_tuning(table)
    tuned, ms_t = _window(cfg, batches, seed, dev)
    _same(untuned, tuned, "tuned window")
    del untuned
    state = fr.init_forest(cfg, seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    window = batches[WARM_BATCHES:2 * WARM_BATCHES]
    busy = 0.0
    for Xb, yb in window:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            state, _ = fr.update(cfg, state, Xb, yb, device=dev)
            torch.cuda.synchronize()
        busy += sum(e.self_device_time_total
                    for e in profile.device_events(prof)) / 1e3
    busy /= len(window)
    print(f"[16] phase 7's window tuned: trees and tables bitwise equal to "
          f"the untuned run; {ms_t:.3f} ms a step (untuned {ms_u:.3f}; "
          f"phase 7 {phase7[0]:.3f}), device busy {busy:.3f} ms a step "
          f"(phase 7 {phase7[1]:.3f}; {smi})", flush=True)

    # op_costs of one step beside its device time, then a trace of a step
    Xb, yb = batches[2 * WARM_BATCHES]
    out = []      # the step consumes the state: keep the one it returns
    costs = profile.op_costs(lambda: out.append(fr.update(cfg, state, Xb, yb,
                                                          device=dev)))
    state = out[0][0]
    print(f"[16] op_costs of one forest.update step: {costs['flops']:.4g} "
          f"flops, {costs['bytes']:.4g} bytes (the kernels' bytes at the "
          f"leaves, nodes and sizes this step's data touched), floor of "
          f"that work {costs['optimal_seconds'] * 1e3:.4f} ms, peak memory "
          f"{costs['peak_memory'] / 2**20:.1f} MiB; measured device time "
          f"{busy:.3f} ms a step ({smi})", flush=True)
    _build.reset_launches()
    Xb, yb = batches[2 * WARM_BATCHES + 1]
    logdir = os.path.join(tmp, "trace")
    with profile.trace(logdir):
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    ran = [k for k in STEP_KERNELS if _build.LAUNCHES[k]]
    files = glob.glob(os.path.join(logdir, "trace_*.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} files in {logdir}")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    for wrapper in ran:
        kernel = STEP_KERNELS[wrapper]
        if not any(kernel in n for n in names):
            raise AssertionError(f"trace: {kernel} launched but not traced")
    print(f"[16] trace of one step ({os.path.getsize(files[0])} bytes, "
          f"{len(names)} kernel names): found {', '.join(ran)}", flush=True)

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_TUNING_CACHE=os.path.join(tmp, "smoke.json"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.perf.tune",
                           "--smoke"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    print(proc.stdout.rstrip(), flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"tune --smoke exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    print(f"[16] python -m repro_torch.perf.tune --smoke: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    kops.set_tuning({})


def phase16(seed, phase7, smi):
    """Phase 16 on its own: the forest's stream from ``seed``, then
    :func:`_tuning_phase` (``phase7``: phase 7's ms a step and device
    busy, for comparison)."""
    import torch
    dev = torch.device("cuda", 0)
    _tuning_phase(forest_config(), stream_batches(seed, dev), seed, dev, smi,
                  phase7)


def _run_phase16(seed, phase7, smi):
    """Phase 16 in a fresh process: once phase 12's engine threads have
    run CUDA work, ``torch.profiler`` records no device activity in this
    process (PERF.md §7), and phase 16 times and traces with it.  The
    kernels are built already (``build/kernels``)."""
    import torch
    torch.cuda.empty_cache()
    code = ("import chip_smoke as cs; "
            f"cs.phase16({seed!r}, {tuple(phase7)!r}, {smi!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase 16 exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")


# ---------------------------------------------------------------------------
# phases 17-19: the LM scaffolding (src/repro_torch/models, optim, train)
# ---------------------------------------------------------------------------

SERVE_B, SERVE_S, SERVE_DECODE = 4, 1024, 32     # phase 17, bf16
CHECK_B, CHECK_S, CHECK_PROMPT = 2, 256, 128     # phase 17, f32 check
GAP_PROMPT = 224                                 # phase 17, bf16 gap
LM_TOL = 1e-3                                    # of max |logit|
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 8, 512, 24   # phase 18(a)
TRAINER_STEPS, TRAINER_KILL = 16, 8              # phase 18(b)
RESUME_TOL = 2e-4                                # tests/test_system.py:59
# NVIDIA's H100 SXM data sheet, bf16 dense (the MFU denominator)
H100_BF16_FLOPS = 989e12
# phase 19: full width, depth cut to fit one card
ARCH_CUTS = (("phi3-mini-3.8b", dict(n_layers=2)),
             ("mistral-nemo-12b", dict(n_layers=2)),
             ("moonshot-v1-16b-a3b", dict(n_layers=2)),
             ("chameleon-34b", dict(n_layers=2)),
             ("falcon-mamba-7b", dict(n_layers=2)),
             ("grok-1-314b", dict(n_layers=1)),
             ("zamba2-2.7b", dict(n_layers=6)),
             ("whisper-medium", dict(n_layers=2, n_enc_layers=2)),
             ("h2o-danube-3-4b", dict(n_layers=2)))
ARCH_B, ARCH_S, ARCH_DECODE, DANUBE_PROMPT = 2, 256, 8, 4608


def _gap(a, b):
    """max |a - b| over max |b| (float64)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def _breakdown(tag, what, fn, wall_ms, reps):
    """Where a call's time goes: the profiler's device ms a call over
    ``reps`` calls (no warm-up: the caller ran it), the busy share of the
    call's ``wall_ms`` and the five largest kernels."""
    from repro_torch.perf import profile
    times = profile.device_times(fn, reps, warm=False)
    if not times:
        print(f"{tag} {what}: the profiler recorded no device time",
              flush=True)
        return
    busy = sum(times.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    print(f"{tag} {what}: device busy {busy:.3f} ms of {wall_ms:.3f} ms "
          f"({busy / wall_ms:.1%}); top kernels "
          + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top), flush=True)


def _teacher_forced(lm, cfg, prompt):
    """Float32 logits (B, S, V) of the cache-free forward."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    p = lm.tree()
    with torch.no_grad():
        h, _, _ = T.forward(p, cfg, p["embed"][prompt].to(L.compute_dtype()),
                            torch.arange(prompt.shape[1],
                                         device=prompt.device))
        h = L.rms_norm(h, p["final_norm"], cfg.norm_eps)
        return L.mm("bsd,dv->bsv", h, p["lm_head"])


def _decode_against(lm, cfg, prompt, n_prompt, full, dev):
    """Prefill ``n_prompt`` tokens, then decode the rest of ``prompt``
    teacher-forced; per position the gap to ``full`` and whether the
    argmax agrees."""
    import torch
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, prompt.shape[0], prompt.shape[1], device=dev)
    cache, lg = M.prefill(lm, cfg, {"tokens": prompt[:, :n_prompt]}, cache)
    gaps = [_gap(lg, full[:, n_prompt - 1])]
    agree = [(lg.argmax(-1) == full[:, n_prompt - 1].argmax(-1)).float()]
    for pos in range(n_prompt, prompt.shape[1]):
        lg, cache = M.decode_step(lm, cfg, prompt[:, pos], cache, pos)
        gaps.append(_gap(lg, full[:, pos]))
        agree.append((lg.argmax(-1) == full[:, pos].argmax(-1)).float())
    return gaps, float(torch.cat(agree).mean())


def _lm_serve(seed, dev, smi):
    """Phase 17: unreduced qwen3-8b served (bf16 compute): prefill, decode,
    decode = teacher forcing in float32, the bf16 gap, and the port's
    attention beside SDPA at the prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    cfg = configs.get_arch("qwen3-8b")
    L.set_compute_dtype(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = M.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n = T.n_params(lm)
    print(f"[17] {cfg.name} unreduced: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.hd}, "
          f"vocab {cfg.vocab}: {n:,} float32 parameters "
          f"({n * 4 / 1e9:.1f} GB), drawn in "
          f"{time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    toks = torch.randint(0, cfg.vocab, (SERVE_B, SERVE_S), generator=gen,
                         device=dev)
    cache = M.init_cache(cfg, SERVE_B, SERVE_S + SERVE_DECODE, device=dev)
    M.prefill(lm, cfg, {"tokens": toks}, cache)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = M.prefill(lm, cfg, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    pf = time.perf_counter() - t0
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for i in range(SERVE_DECODE):
        logits, cache = M.decode_step(lm, cfg, tok, cache, SERVE_S + i)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) / SERVE_DECODE
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("phase 17: decode logits not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[17] bf16 prefill B={SERVE_B} x S={SERVE_S}: {pf * 1e3:.1f} ms "
          f"= {SERVE_B * SERVE_S / pf:,.0f} tokens/s; decode "
          f"{SERVE_DECODE} steps of B={SERVE_B}: {dec * 1e3:.2f} ms/token "
          f"step ({SERVE_B / dec:,.1f} tokens/s); peak memory {peak:.1f} GB; "
          f"{smi}", flush=True)
    last = SERVE_S + SERVE_DECODE - 1
    _breakdown("[17]", "prefill", lambda: M.prefill(
        lm, cfg, {"tokens": toks}, cache), pf * 1e3, 1)
    _breakdown("[17]", "decode step", lambda: M.decode_step(
        lm, cfg, tok, cache, last), dec * 1e3, 3)
    del cache

    # decode = teacher forcing, float32 compute, TF32 off
    L.set_compute_dtype(torch.float32)
    prompt = toks[:CHECK_B, :CHECK_S]
    full = _teacher_forced(lm, cfg, prompt)
    gaps, agree = _decode_against(lm, cfg, prompt, CHECK_PROMPT, full, dev)
    print(f"[17] float32: prefill {CHECK_PROMPT} then {CHECK_S - CHECK_PROMPT}"
          f" teacher-forced decode steps, B={CHECK_B}: max |decode - "
          f"forward| / max |forward| = {max(gaps):.3g} (limit {LM_TOL}), "
          f"argmax agreement {agree:.4f}", flush=True)
    if max(gaps) > LM_TOL:
        raise AssertionError(f"phase 17: decode differs from teacher "
                             f"forcing by {max(gaps):.3g} of max |logit|")
    del full
    L.set_compute_dtype(torch.bfloat16)
    full = _teacher_forced(lm, cfg, prompt)
    gaps, agree = _decode_against(lm, cfg, prompt, GAP_PROMPT, full, dev)
    print(f"[17] bf16: prefill {GAP_PROMPT} then {CHECK_S - GAP_PROMPT} "
          f"decode steps: max gap {max(gaps):.3g} of max |logit| (median "
          f"{statistics.median(gaps):.3g}), argmax agreement {agree:.4f}",
          flush=True)
    del full, lm
    torch.cuda.empty_cache()

    # the port's attention beside SDPA at the prefill shape (recorded)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((SERVE_B, SERVE_S, H, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((SERVE_B, SERVE_S, Hkv, hd), generator=gen,
                        device=dev, dtype=torch.bfloat16) for _ in range(2))
    pos = torch.arange(SERVE_S, device=dev)
    ours = lambda: L._online_softmax_scan(q, k, v, pos, pos, causal=True,
                                          window=0, kv_chunk=512,
                                          n_rep=H // Hkv)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)
    with torch.no_grad():
        diff = float((ours().float() - sdpa().float()).abs().max())
        ms_ours, ms_sdpa = _time_ms(ours), _time_ms(sdpa)
    print(f"[17] attention B={SERVE_B} S={SERVE_S} H={H}/{Hkv} hd={hd} "
          f"causal bf16: the port's chunked online softmax {ms_ours:.3f} ms, "
          f"SDPA {ms_sdpa:.3f} ms (x{ms_ours / ms_sdpa:.1f}); max |diff| "
          f"{diff:.3g}; {smi}", flush=True)


def _tables_close(card, host, what):
    """The card's monitor against the host copy: counts equal; means,
    sums and the table's radius and origin within 1e-6 of the leaf's
    largest magnitude; each bin's m2 within 1e-6 of the bin's sum of
    squares n * mean^2 + m2 (the scale its float32 rounding follows, as
    phase 3 scales the single table's sums)."""
    import torch
    for name, tab in host.items():
        got = {k: v.cpu() for k, v in card[name]["y"].items()}
        ref = tab["y"]
        if not torch.equal(got["n"], ref["n"]):
            raise AssertionError(f"{what} {name}/y/n: counts differ")
        pairs = [("y/mean", got["mean"], ref["mean"], ref["mean"].abs().max()),
                 ("y/m2", got["m2"], ref["m2"],
                  ref["n"] * ref["mean"] ** 2 + ref["m2"].abs())]
        pairs += [(k, card[name][k].cpu(), tab[k], tab[k].abs().max())
                  for k in ("sum_x", "radius", "origin")]
        for leaf, a, b, scale in pairs:
            err = (a.double() - b.double()).abs()
            if bool((err > 1e-6 * scale.double()).any()):
                raise AssertionError(f"{what} {name}/{leaf}: differs by "
                                     f"{float(err.max()):.3g}")


def _lm_train(seed, dev, smi):
    """Phase 18(a): qwen3-8b at full width, depth cut to TRAIN_LAYERS,
    TRAIN_STEPS steps through build_train_step with the monitor."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import monitor as MON
    from repro_torch.train import steps as ST
    cfg = dataclasses.replace(configs.get_arch("qwen3-8b"),
                              n_layers=TRAIN_LAYERS)
    L.set_compute_dtype(torch.bfloat16)
    shape = ShapeConfig("phase18", TRAIN_S, TRAIN_B, "train")
    step = ST.build_train_step(cfg, shape, adamw.AdamWConfig(
        lr=3e-4, warmup_steps=4, total_steps=TRAIN_STEPS), device=dev)
    lm = M.init_params(cfg, seed=seed, device=dev)
    opt = adamw.init_state(lm)
    n = T.n_params(lm)
    data = TokenStream(cfg.vocab, TRAIN_S, TRAIN_B, seed=seed,
                       device=str(dev))
    mon = MON.init_monitor(device=dev)
    host = MON.init_monitor(device="cpu")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        t0 = time.perf_counter()
        lm, opt, met, mon = step(lm, opt, batch, mon)
        loss = float(met["loss"])
        dt = time.perf_counter() - t0
        mon = MON.observe(mon, step_time=dt)
        host = MON.observe(host, loss=met["loss"].cpu(),
                           grad_norm=met["grad_norm"].cpu(), step_time=dt)
        losses.append(loss)
        times.append(dt)
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["qo_update"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    sec = statistics.median(times[2:])
    tokens = TRAIN_B * TRAIN_S
    mfu = 6 * n * tokens / sec / H100_BF16_FLOPS
    print(f"[18a] {cfg.name} full width, depth cut 36 -> {TRAIN_LAYERS} "
          f"layers: {n:,} parameters; B={TRAIN_B} x S={TRAIN_S}, "
          f"{TRAIN_STEPS} steps, bf16 compute, AdamW + monitor", flush=True)
    print(f"[18a] loss " + " ".join(f"{x:.3f}" for x in losses))
    print(f"[18a] {sec * 1e3:.1f} ms/step (median after 2; first "
          f"{times[0] * 1e3:.0f} ms), {tokens / sec:,.0f} tokens/s, MFU "
          f"{mfu:.3f} (6 N tokens / time over the data sheet's 989 "
          f"TFLOP/s bf16 dense); peak memory {peak:.1f} GB; qo_update "
          f"launches {launches}; {smi}", flush=True)
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and statistics.mean(losses[-4:]) < statistics.mean(losses[:4])):
        raise AssertionError(f"phase 18a: the loss did not fall: {losses}")
    if launches < 3 * TRAIN_STEPS:
        raise AssertionError(f"phase 18a: qo_update launched {launches} "
                             f"times, expected >= {3 * TRAIN_STEPS}")
    _tables_close(mon, host, "phase 18a monitor")
    s = MON.summaries(mon)
    print(f"[18a] monitor = its host copy (counts equal, 1e-6): loss p50 "
          f"{float(s['loss']['p50']):.3f}, grad_norm p50 "
          f"{float(s['grad_norm']['p50']):.3f}, step_time p99 "
          f"{float(s['step_time']['p99']):.3f} s", flush=True)
    # two more steps, after the checks, under the profiler
    batch = data.batch(TRAIN_STEPS)
    _breakdown("[18a]", "train step", lambda: step(lm, opt, batch, mon),
               sec * 1e3, 2)


def _lm_trainer(seed, dev, smi):
    """Phase 18(b): the Trainer end to end at a reduced width: killed by
    SIGTERM after step TRAINER_KILL, resumed, against an uninterrupted
    run under torch.use_deterministic_algorithms."""
    import signal
    import tempfile
    import warnings
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    from repro_torch.train.loop import LoopConfig, Trainer
    cfg = configs.reduced(configs.get_arch("qwen3-8b"), d_model=256,
                          n_layers=2, n_heads=8, n_kv_heads=8, d_ff=1024,
                          head_dim=32)
    L.set_compute_dtype(torch.bfloat16)
    shape = ShapeConfig("phase18b", 128, 8, "train")
    data = TokenStream(cfg.vocab, 128, 8, seed=seed, device=str(dev))
    opt = adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                            total_steps=TRAINER_STEPS)

    def trainer(d, log_every=4):
        return Trainer(cfg, shape, data, LoopConfig(
            total_steps=TRAINER_STEPS, ckpt_every=TRAINER_KILL,
            log_every=log_every, ckpt_dir=d, seed=seed), opt, device=dev)

    def kill(rec):
        if rec.get("step") == TRAINER_KILL - 1 and "loss" in rec:
            signal.raise_signal(signal.SIGTERM)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pubs = {"full": [], "killed": [], "resumed": []}
            full = trainer(os.path.join(tmp, "full"))
            p_full, o_full, _, hist = full.run(
                log_fn=lambda r: None,
                publish_fn=lambda s, p: pubs["full"].append(s))
            cut = trainer(os.path.join(tmp, "cut"), log_every=1)
            _, _, _, hist_k = cut.run(
                log_fn=kill, publish_fn=lambda s, p: pubs["killed"].append(s))
            resumed = trainer(os.path.join(tmp, "cut"))
            if resumed.ckpt.latest_step() != TRAINER_KILL:
                raise AssertionError("phase 18b: no checkpoint at the kill")
            p_res, o_res, _, _ = resumed.run(
                log_fn=lambda r: None,
                publish_fn=lambda s, p: pubs["resumed"].append(s))
            ck = Checkpointer(os.path.join(tmp, "timed"))
            tree = {"params": p_res.tree(), "opt": o_res}
            nbytes = sum(t.numel() * t.element_size()
                         for _, t in tree_leaves(tree))
            t0 = time.perf_counter()
            ck.save(TRAINER_STEPS, tree, blocking=True)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ck.restore(TRAINER_STEPS, dict(zip(
                ("params", "opt"), ST.abstract_state(cfg))))
            restore_ms = (time.perf_counter() - t0) * 1e3
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
    worst, bitwise = 0.0, True
    for a, b in ((p_full.tree(), p_res.tree()), (o_full, o_res)):
        for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
            if not torch.equal(x, y):
                bitwise = False
                worst = max(worst, float((x.double() - y.double()).abs()
                                         .max()))
    print(f"[18b] Trainer on reduced {cfg.name} (d {cfg.d_model}, "
          f"{cfg.n_layers} layers, vocab {cfg.vocab}; B=8 x S=128): "
          f"losses {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}; SIGTERM "
          f"after step {hist_k[-1]['step'] + 1} -> final save; resumed from "
          f"{TRAINER_KILL}: {'bitwise equal' if bitwise else f'max |diff| {worst:.3g}'}"
          f" to the uninterrupted run (params and AdamW state); publish "
          f"at {pubs}; non-deterministic ops warned: {nondet or 'none'}",
          flush=True)
    print(f"[18b] blocking save of {nbytes / 1e6:.1f} MB {save_ms:.1f} ms, "
          f"restore {restore_ms:.1f} ms; {smi}", flush=True)
    if pubs != {"full": [TRAINER_KILL, TRAINER_STEPS, TRAINER_STEPS],
                "killed": [TRAINER_KILL, TRAINER_KILL],
                "resumed": [TRAINER_STEPS, TRAINER_STEPS]}:
        raise AssertionError(f"phase 18b: publish_fn at {pubs}")
    if hist[-1]["loss"] >= hist[0]["loss"]:
        raise AssertionError("phase 18b: the Trainer's loss did not fall")
    if not bitwise and (worst > RESUME_TOL or not nondet):
        raise AssertionError(f"phase 18b: resume differs by {worst:.3g}")


def _arch_batch(cfg, B, S, gen, dev, labels=True):
    import torch
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=dev)}
    if labels:
        b["labels"] = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                    device=dev)
    if cfg.family == "encdec":
        b["enc_in"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                  generator=gen, device=dev)
    if cfg.family == "vlm" and labels:
        b["loss_mask"] = torch.ones((B, S), device=dev)
    return b


def _arch_on_card(name, cut, seed, dev, smi):
    """Phase 19, one arch at full width: lm_loss forward + backward,
    prefill + ARCH_DECODE decode steps (bf16 compute)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    full = configs.get_arch(name)
    cfg = dataclasses.replace(full, **cut)
    L.set_compute_dtype(torch.bfloat16)
    lm = M.init_params(cfg, seed=seed, device=dev)
    n = T.n_params(lm)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 19)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, m = M.lm_loss(lm, cfg, _arch_batch(cfg, ARCH_B, ARCH_S, gen, dev))
    loss.backward()
    torch.cuda.synchronize()
    fb = (time.perf_counter() - t0) * 1e3
    if not (math.isfinite(float(loss.detach())) and all(
            bool(torch.isfinite(p.grad).all()) for p in lm.parameters())):
        raise AssertionError(f"phase 19 {name}: loss or gradients not finite")
    if cfg.is_moe and not float(m["aux"].detach()) > 0:
        raise AssertionError(f"phase 19 {name}: MoE aux loss not positive")
    peak = torch.cuda.max_memory_allocated() / 1e9
    for p in lm.parameters():
        p.grad = None
    S = DANUBE_PROMPT if cfg.swa_window else ARCH_S
    cache = M.init_cache(cfg, ARCH_B, S + ARCH_DECODE, device=dev)
    batch = _arch_batch(cfg, ARCH_B, S, gen, dev, labels=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = M.prefill(lm, cfg, batch, cache)
    torch.cuda.synchronize()
    pf = time.perf_counter() - t0
    tok = logits.argmax(-1)
    t0 = time.perf_counter()
    for i in range(ARCH_DECODE):
        logits, cache = M.decode_step(lm, cfg, tok, cache, S + i)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) / ARCH_DECODE * 1e3
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"phase 19 {name}: decode logits not finite")
    ring = ""
    if "pos" in cache.get("attn", {}):
        W = cache["attn"]["k"].shape[2]
        ring = f", ring cache of {W} slots wrapped past {S} tokens"
        if not S > W:
            raise AssertionError(f"phase 19 {name}: the ring did not wrap")
    cut_s = ", ".join(f"{k} {getattr(full, k)} -> {v}" for k, v in cut.items())
    print(f"[19] {name}: {cut_s}; {n:,} parameters; fwd+bwd B={ARCH_B} x "
          f"S={ARCH_S} {fb:.1f} ms (loss {float(loss.detach()):.3f}, aux "
          f"{float(m['aux'].detach()):.3f}, peak {peak:.1f} GB); prefill B={ARCH_B} x "
          f"S={S} {ARCH_B * S / pf:,.0f} tokens/s; decode {dec:.2f} ms/token "
          f"step{ring}", flush=True)
    del lm, cache
    torch.cuda.empty_cache()


def _arch_card_vs_host(name, seed, dev):
    """Phase 19: reduced(name) in float32 on the card and on the host with
    the same parameters and batch: loss, gradients' norm and prefill
    logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch import configs, convert
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = configs.reduced(configs.get_arch(name))
    L.set_compute_dtype(torch.float32)
    host = M.init_params(cfg, seed=seed, device="cpu")
    card = convert.lm_params_from_numpy(
        cfg, convert.lm_params_to_numpy(host), device=dev)
    rng = np.random.default_rng(seed + 19)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 32)),
         "labels": rng.integers(0, cfg.vocab, (2, 32))}
    if cfg.family == "encdec":
        b["enc_in"] = rng.standard_normal((2, cfg.enc_seq, cfg.d_model),
                                          dtype=np.float32)
    outs = {}
    for where, lm in (("cpu", host), (dev, card)):
        tb = {k: torch.as_tensor(v, device=where) for k, v in b.items()}
        loss, _ = M.lm_loss(lm, cfg, tb, kv_chunk=16, loss_chunk=16)
        loss.backward()
        cache = M.init_cache(cfg, 2, 40, device=where)
        _, lg = M.prefill(lm, cfg, {k: v for k, v in tb.items()
                                    if k != "labels"}, cache, kv_chunk=16)
        outs[str(where)] = (loss.detach().cpu(), lg.cpu(), [
            p.grad.cpu() for p in lm.parameters() if p.grad is not None])
    (l0, g0, gr0), (l1, g1, gr1) = outs["cpu"], outs[str(dev)]
    errs = [_gap(l1, l0), _gap(g1, g0)] + [_gap(a, b) for a, b in
                                           zip(gr1, gr0) if b.abs().max() > 0]
    if max(errs) > TOL:
        raise AssertionError(f"phase 19 {name}: card and host differ by "
                             f"{max(errs):.3g}")
    return max(errs)


def lm_phases(seed, smi):
    """Phases 17-19 on their own (a fresh process: the qwen3-8b phases use
    up to ~70 GB of the card, and 18(b)'s deterministic cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG before the first GEMM)."""
    import torch
    from repro_torch.kernels import _build
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lm_serve(seed, dev, smi)
    t1 = time.perf_counter()
    _lm_train(seed, dev, smi)
    torch.cuda.empty_cache()
    _lm_trainer(seed, dev, smi)
    t2 = time.perf_counter()
    errs = {}
    for name, cut in ARCH_CUTS:
        _arch_on_card(name, cut, seed, dev, smi)
    for name in sorted(dict(ARCH_CUTS)) + ["qwen3-8b"]:
        errs[name] = _arch_card_vs_host(name, seed, dev)
    print(f"[19] reduced archs, float32, card vs host (same parameters and "
          f"batch; loss, prefill logits, every gradient): max gap "
          + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
          + f" (limit {TOL}); {smi}", flush=True)
    print(f"[17-19] phase 17 {t1 - t0:.1f} s, phase 18 {t2 - t1:.1f} s, "
          f"phase 19 {time.perf_counter() - t2:.1f} s", flush=True)


def _run_lm_phases(seed, smi):
    """Phases 17-19 in a fresh process (see :func:`lm_phases`)."""
    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as cs; cs.lm_phases({seed!r}, {smi!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phases 17-19 exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")


PHASE18A_MS = 364.8   # phase 18a's ms a step, NVIDIA H100 80GB HBM3, 700 W
SHARDED_STEPS = 8                                 # phase 20(a)
DRYRUN_CELLS = (("phi3-mini-3.8b", "decode_32k"), ("qwen3-8b", "train_4k"))


def _agree(a, b, what, step):
    """|a - b| within TOL of max(1, |b|) for two float metrics."""
    if not abs(a - b) <= TOL * max(1.0, abs(b)):
        raise AssertionError(f"phase 20a step {step}: sharded {what} {a!r} "
                             f"vs unsharded {b!r}")


def _run_dryruns(tmp):
    """Phase 20(b): the two dry-run cells, each a subprocess of its own
    (the dry-run's fake 512-rank group must be its process's first),
    run at once."""
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(tmp, f"{arch}_{shape}.json")
        procs.append((arch, shape, out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cells = {}
    for arch, shape, out, t0, proc in procs:
        log, _ = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 20b: the dry-run of {arch} x "
                                 f"{shape} exited {proc.returncode}:\n"
                                 f"{log[-4000:]}")
        with open(out) as f:
            r = json.load(f)[0]
        if r["status"] != "ok" or r["chips"] != 256:
            raise AssertionError(f"phase 20b: {arch} x {shape}: {r}")
        print(f"[20b] dry-run {arch} x {shape} on the fake 16x16 mesh: "
              f"status {r['status']}, {r['chips']} ranks; rank 0: "
              f"{r['hlo_flops_per_chip']:.4g} flops, "
              f"{r['hlo_bytes_per_chip']:.4g} bytes, "
              f"{r['collective_bytes_per_chip']:.4g} collective bytes "
              f"{json.dumps(r['collective_breakdown'])}; t_compute "
              f"{r['t_compute_s']:.4g} s, t_memory {r['t_memory_s']:.4g} s, "
              f"t_collective {r['t_collective_s']:.4g} s (a lower bound), "
              f"bottleneck {r['bottleneck']}, useful_flops_ratio "
              f"{r['useful_flops_ratio']:.4f}; {secs:.1f} s", flush=True)
        cells[(arch, shape)] = r
    return cells


def sharded_lm_phase(seed, smi):
    """Phase 20 on its own (a fresh process, as phases 17-19): the LM's
    sharded train step through a one-rank NCCL ``DeviceMesh`` against the
    unsharded step, the dry-run in subprocesses and the op-count walker
    over one sharded step."""
    import dataclasses
    import datetime
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun, hlocost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import monitor as MON
    from repro_torch.train import steps as ST

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="phase20_")

    cfg = dataclasses.replace(configs.get_arch("qwen3-8b"),
                              n_layers=TRAIN_LAYERS)
    L.set_compute_dtype(torch.bfloat16)
    shape = ShapeConfig("phase20", TRAIN_S, TRAIN_B, "train")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=4,
                                total_steps=TRAIN_STEPS)
    data = TokenStream(cfg.vocab, TRAIN_S, TRAIN_B, seed=seed,
                       device=str(dev))
    n_steps = SHARDED_STEPS + 2        # + one seq_parallel, one "gather"
    tokens = TRAIN_B * TRAIN_S

    def run(step_of, lm):
        opt = adamw.init_state(lm)
        mon = MON.init_monitor(device=dev)
        mets, times, counts = [], [], []
        for i in range(n_steps):
            batch = data.batch(i)
            _sync()
            before = _build.LAUNCHES["qo_update"]
            t0 = time.perf_counter()
            lm, opt, met, mon = step_of(i)(lm, opt, batch, mon)
            loss = float(met["loss"])
            dt = time.perf_counter() - t0
            mon = MON.observe(mon, step_time=dt)
            _sync()
            counts.append(_build.LAUNCHES["qo_update"] - before)
            mets.append((loss, float(met["grad_norm"])))
            times.append(dt)
        return lm, opt, mon, mets, times, counts

    # the unsharded step (phase 18a's), the reference for every step
    plain = ST.build_train_step(cfg, shape, opt_cfg, device=dev)
    lm = M.init_params(cfg, seed=seed, device=dev)
    n = T.n_params(lm)
    _build.reset_launches()
    _, _, _, ref, ref_t, _ = run(lambda i: plain, lm)
    del lm, plain
    torch.cuda.empty_cache()

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_local_mesh(1, 1)
        steps = {kw: ST.build_train_step(cfg, shape, opt_cfg, device=dev,
                                         mesh=mesh, **dict(kw))
                 for kw in ((), (("seq_parallel", True),),
                            (("sharding_style", "gather"),))}
        order = [()] * SHARDED_STEPS + [(("seq_parallel", True),),
                                        (("sharding_style", "gather"),)]
        lm = M.init_params(cfg, seed=seed, device=dev, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        lm, opt, mon, got, got_t, counts = run(lambda i: steps[order[i]], lm)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = _build.LAUNCHES["qo_update"]
        bitwise = got == ref
        for i, ((l, g), (lr, gr)) in enumerate(zip(got, ref)):
            _agree(l, lr, "loss", i)
            _agree(g, gr, "grad norm", i)
        if counts != [3] * n_steps:
            raise AssertionError(f"phase 20a: qo_update launches a step "
                                 f"{counts}, expected 3 each")
        sec = statistics.median(got_t[2:SHARDED_STEPS])
        sec_u = statistics.median(ref_t[2:SHARDED_STEPS])
        mfu = lambda t: 6 * n * tokens / t / H100_BF16_FLOPS
        gap = max(max(abs(a - b) for a, b in zip(x, y))
                  for x, y in zip(got, ref))
        print(f"[20a] {cfg.name} full width, {TRAIN_LAYERS} layers "
              f"({n:,} parameters), B={TRAIN_B} x S={TRAIN_S}, bf16: "
              f"build_train_step(mesh=) over a one-rank NCCL DeviceMesh "
              f"(1 x 1, data/model) for {SHARDED_STEPS} steps, then one "
              f"seq_parallel and one sharding_style='gather' step, "
              f"against the unsharded step on the same weights and "
              f"batches: loss and grad norm within {TOL} on every step "
              f"(max gap {gap:.3g}; bitwise equal: {bitwise}); qo_update "
              f"{launches} launches ({counts[0]} a step)", flush=True)
        print(f"[20a] loss " + " ".join(f"{l:.4f}" for l, _ in got))
        print(f"[20a] sharded {sec * 1e3:.1f} ms/step, {tokens / sec:,.0f} "
              f"tokens/s, MFU {mfu(sec):.3f}; unsharded in this process "
              f"{sec_u * 1e3:.1f} ms/step, {tokens / sec_u:,.0f} tokens/s, "
              f"MFU {mfu(sec_u):.3f} (median of steps 2-7; phase 18a "
              f"recorded {PHASE18A_MS} ms); DTensor overhead "
              f"{(sec - sec_u) * 1e3:.1f} ms a step; peak memory "
              f"{peak:.1f} GB; {smi}", flush=True)

        # ---- 20c: the walker over one sharded step -----------------------
        batch = data.batch(n_steps)
        walked = hlocost.analyze(lambda: steps[()](lm, opt, batch, mon))
        mf = dryrun.model_flops(cfg, shape)
        print(f"[20c] hlocost.analyze of one sharded step: "
              f"{walked['flops']:.4g} flops ({walked['flops'] / mf:.3f} x "
              f"model_flops = 6 N tokens = {mf:.4g}), "
              f"{walked['bytes']:.4g} bytes, collectives "
              f"{json.dumps(walked['collectives'])}", flush=True)
        # 6 N tokens counts the embedding table's products, which a
        # lookup never does, and not remat's second forward nor attention
        if not 0.5 * mf <= walked["flops"] <= 2.0 * mf:
            raise AssertionError(f"phase 20c: the walker counted "
                                 f"{walked['flops']} flops, outside half "
                                 f"to twice 6 N tokens {mf}")
    finally:
        dist.destroy_process_group()
    try:
        _run_dryruns(tmp)          # 20b, after 20a: no host contention
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_phase20(seed, smi):
    """Phase 20 in a fresh process (see :func:`sharded_lm_phase`)."""
    import torch
    torch.cuda.empty_cache()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as cs; cs.sharded_lm_phase({seed!r}, {smi!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"phase 20 exited {proc.returncode}:\n"
                             f"{proc.stderr[-6000:]}")
    print(f"[20] phase 20 took {time.perf_counter() - t0:.1f} s",
          flush=True)


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
    from repro_torch.core import serve as sv
    from repro_torch.data import synth
    from repro_torch.kernels import _build, qo_update_leaves
    from repro_torch.perf import profile
    from repro_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    load_probes = _start_probe()
    libs = _build.build()
    probes = load_probes(dev)
    print(f"[2] built {len(libs)} kernel sources and the latency probes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {name}: {line.strip()}")

    cfg = forest_config()
    batches = stream_batches(args.seed, dev)
    scfg = forest_config(observer_backend="sketch", sketch_k=KS)
    sbatches = [(torch.exp(Xb), yb) for Xb, yb in batches]

    # ---- 3. per kernel at the full-width shapes -------------------------
    state = fr.init_forest(cfg, args.seed, device=dev)
    for Xb, yb in batches[:WARM_BATCHES]:
        state, _ = fr.update(cfg, state, Xb, yb, device=dev)
    trees = state["trees"]
    Xk, yk = batches[WARM_BATCHES]
    row, route_k = _route_row(trees, Xk)
    rows = [row]

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
    bound, by = profile.bound(*qo_update_leaves.cost(T * M, T * B, B, F, C,
                                                     touched=touched))
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
    rows.append(_leaf_stats_row(trees, gl, yk, w, "the step's sort"))
    root = gl.clone()
    root[:B] = 0                        # tree 0 a fresh tree: one root run
    _leaf_stats_row(trees, root, yk, w, "a root holding its tree's batch")
    # the drift test at the stable cells' T = 10 and at T = 64
    rows.append(_drift_test_row(cfg, 10, args.seed, dev))
    _drift_test_row(cfg, 64, args.seed + 1, dev)

    qrows = _attempt_rows(cfg, trees, gl, yk, w)
    rows.append(_query_row(ty_k, tsx_k, qrows, "QO forest", True))
    del ty_k, tsx_k, ty_p, tsx_p, scratch_k, scratch_p, state, trees
    sin = _sketch_inputs(scfg, sbatches, args.seed, dev)
    row, merged = _sketch_compact_row(sin)
    rows.append(row)
    # the sketch forest's attempt set at C = K = 16: two tables a warp
    stab = [a.reshape(T * M, F, KS) for a in merged]
    sy, ssx = kops.sketch_to_bins({"n": stab[0], "mean": stab[1],
                                   "m2": stab[2]}, stab[3])
    _query_row(sy, ssx, _attempt_rows(scfg, sin["trees"], sin["gl"],
                                      sin["yk"], sin["w"]),
               "sketch forest", False)
    del sin, merged, stab, sy, ssx
    rows.extend(_qo_rows(args.seed, dev))
    rows.append(_qo_merge_row(cfg, batches, args.seed, dev))
    rows.extend(_ebst_rows(args.seed, dev, probes))

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
    for name in ("qo_route", "qo_update_leaves", "leaf_stats",
                 "drift_test", "qo_query_batched"):
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

    phase7 = _profile(cfg, batches, args.seed, dev)

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

    # ---- 12. the serving engine -------------------------------------------
    _engine_phase(cfg, batches, args.seed, dev, smi)

    # ---- 13. sharded training, serving and all_merge ----------------------
    _sharded_phase(cfg, batches, args.seed, dev)

    # ---- 14. the attribute-observer comparison ---------------------------
    t0 = time.perf_counter()
    ao_launches = _ao_phase(args.seed, dev, probes, smi)

    # ---- 15. multi-target QO, telemetry, sparsification, oracle ----------
    _phase15(batches, args.seed, dev)
    print(f"[15] phases 14 and 15 took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 16. the perf layer: tuner, cache, op costs, trace ---------------
    _run_phase16(args.seed, phase7, smi)

    # ---- 17-19. the LM scaffolding: serving, training, the other archs ---
    _run_lm_phases(args.seed, smi)

    # ---- 20. the LM's sharding layer ---------------------------------------
    _run_phase20(args.seed, smi)

    # launches from the phase whose path runs each kernel
    for row in rows:
        row["launches"] = {"sketch_compact": sketch_launches,
                           "qo_update": qo_launches,
                           "qo_query": qo_launches,
                           "qo_merge": dp_launches,
                           "ebst_insert": ao_launches,
                           "ebst_query": ao_launches}.get(
                               row["name"], launches)[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
