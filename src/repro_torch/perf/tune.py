"""Measured tuner of the CUDA kernels' launch shapes.

Each kernel's rows, warps or threads a block is a *schedule* knob: every
compiled value (a template instantiation of its own) gives the same bits,
and today's values were picked by hand.  This module races them:

    python -m repro_torch.perf.tune            # tune + cache (on the card)
    python -m repro_torch.perf.tune --smoke    # tiny grid and shapes

For each (family, backend, shape class) it runs every candidate of
:data:`SEARCH_SPACE` through the PUBLIC op of :mod:`repro_torch.kernels.ops`
(so a candidate pays what a real call pays).  Before anything is timed,
each candidate's output must be *bitwise* equal to the all-defaults
output, NaN equal to NaN: a candidate that changes one bit is a kernel
bug, not a schedule, and the tuner stops (:class:`TuningError`).  Then an
interleaved race: ``reps`` rounds, each visiting every candidate, which
keeps its best round (load moves all candidates of a round together).

What is timed.  On the card a call at the forest's shapes is mostly host
time (on an H100 80GB HBM3 at 700 W a route launch took ~5 us of device
time inside a ~70 us call, PERF.md), so a race on host time picks noise.
Each candidate's ``inner`` back-to-back calls are timed three ways: host
time between two ``torch.cuda.synchronize()``, CUDA events around the
same calls (the stream's time, which still includes the host's gaps
between launches), and under ``torch.profiler`` the device time of the
one kernel the knobs steer (:data:`KERNEL_OF`: a sketch update's
pre-sketch, or the query's row compaction, is the same for every
candidate and would only add its noise).  The race is ranked by that
kernel's time; the entry records all three.  On the CPU (backend
``plain``) there is no device: host time ranks.  A candidate wins only
if it beats the defaults by more than the spread of the race (the larger
of the two candidates' best-to-worst rounds, ``spread_us``); otherwise
the defaults are the entry's params.

A knob of a kernel the shape class never launches is left out of that
class's grid: the compaction runs its fast kernel (``warps``) where a
row's 2K centroids fit a warp and its general one (``gen_warps``)
elsewhere, so only one of the two is raced.

The stream knobs (:data:`KERNEL_STREAM_KNOBS`) set how a batch flows
through a sequential Chan merge, so another value would reorder f32 sums:
each has one compiled value, which :data:`SEARCH_SPACE` records, and the
two update families that have only those are not tuned.  The plain
versions never see a knob at all, so on ``plain`` every candidate is
trivially bit-identical (the CPU smoke exercises the loop, not a choice).

Winners persist to a JSON cache in the reference's format (version 1,
keys ``device kind|family|backend|shape class``) in its own file
(:func:`cache_path`), keyed by the card's name: :func:`install` drops the
entries of any other device kind before :func:`repro_torch.kernels.ops.
set_tuning` sees them.  Every grid contains the defaults, so an installed
winner is never measurably worse on the card that measured it.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time

import numpy as np
import torch

from repro_torch.kernels import (ops as kops, qo_merge, qo_query_batched,
                                 qo_route, sketch_compact)
from repro_torch.perf import profile

__all__ = [
    "SEARCH_SPACE", "KERNEL_STREAM_KNOBS", "SMOKE_SPACE", "SMOKE_SHAPES",
    "TUNE_FAMILIES", "KERNEL_OF", "TuningError", "idle_knobs", "candidates",
    "make_workloads", "tune_family", "tune", "cache_path", "load_cache", "save_cache",
    "install", "ensure", "device_kind", "resolve_backend", "main",
]

#: Candidate values of every knob, per dispatch family: exactly the values
#: each kernel is compiled for (its module's ``*_CHOICES``), so the grid
#: and the compiled set cannot drift apart; a stream knob's one compiled
#: value.  Contains :data:`repro_torch.kernels.ops.DEFAULT_PARAMS`.
SEARCH_SPACE = {
    "qo_update": {k: (v,) for k, v in
                  kops.DEFAULT_PARAMS["qo_update"].items()},
    "forest_update": {k: (v,) for k, v in
                      kops.DEFAULT_PARAMS["forest_update"].items()},
    "forest_query": {"warps": qo_query_batched.WARPS_CHOICES},
    "forest_route": {"rows": qo_route.ROWS_CHOICES},
    "forest_merge": {"threads": qo_merge.THREADS_CHOICES},
    "sketch_update": {"warps": sketch_compact.WARPS_CHOICES,
                      "gen_warps": sketch_compact.GEN_WARPS_CHOICES},
    "sketch_merge": {"warps": sketch_compact.WARPS_CHOICES,
                     "gen_warps": sketch_compact.GEN_WARPS_CHOICES},
}

#: Knobs never searched: they cut a batch for a sequential Chan merge
#: (``csrc/qo_update_leaves.cu`` ``PIECE_ROWS``; ``csrc/qo_update.cu``
#: ``STEP``, ``TILE_BINS`` and the piece count), so another value would
#: reorder f32 accumulation -- a semantics knob, compiled once.  The
#: sketch families have none: a batch is one compaction and a row lives
#: in one warp.
KERNEL_STREAM_KNOBS = {
    "forest_update": ("piece_rows",),
    "qo_update": ("pieces", "step", "tile_bins"),
}

#: The kernel each tuned family's knobs steer: its names in a profile
#: start with this.  The families :func:`tune` covers; the two update
#: families have stream knobs alone, one candidate, nothing to race.
KERNEL_OF = {"forest_query": "qo_query_batched", "forest_route": "qo_route",
             "forest_merge": "qo_merge", "sketch_update": "sketch_compact",
             "sketch_merge": "sketch_compact"}
TUNE_FAMILIES = tuple(KERNEL_OF)

#: The first and last value of each knob: the whole tune -> gate -> save
#: -> load -> install loop in seconds.
SMOKE_SPACE = {
    fam: {k: (v[0], v[-1]) if len(v) > 1 else v for k, v in knobs.items()}
    for fam, knobs in SEARCH_SPACE.items()
}

#: Workload shapes of the smoke run (full-run defaults: make_workloads).
SMOKE_SHAPES = dict(M=64, F=4, C=8, T=4, B=260)


class TuningError(AssertionError):
    """A candidate schedule changed the op's output bits -- a kernel
    semantics bug, never a legal tuning outcome."""


def device_kind() -> str:
    """Tuning-cache namespace of this host: the card's name, or
    ``"cpu"``; entries never cross device kinds."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


def resolve_backend(backend: str | None) -> str:
    """None -> ``"cuda"`` where a card is visible, else ``"plain"``."""
    if backend is None:
        return "cuda" if torch.cuda.is_available() else "plain"
    if backend not in ("cuda", "plain"):
        raise ValueError(f"backend {backend!r}: expected 'cuda' or 'plain'")
    return backend


def idle_knobs(family: str, shape_class: str | None) -> tuple:
    """The family's knobs whose kernel ``shape_class`` never launches:
    a sketch family's compaction merges 2K centroids a row, on the fast
    kernel (``warps``) where they fit a warp and on the general one
    (``gen_warps``) elsewhere.  ``()`` without a shape class."""
    if shape_class is None or family not in ("sketch_update",
                                             "sketch_merge"):
        return ()
    K = int(shape_class.rsplit("C", 1)[1])
    return ("gen_warps",) if sketch_compact.fast_kernel(2 * K, K) \
        else ("warps",)


def candidates(family: str, space: dict | None = None,
               shape_class: str | None = None) -> list[dict]:
    """The family's grid as full param dicts (the cross product of
    ``space[family]``, defaults filled in), with the stream knobs, and the
    knobs ``shape_class`` never launches (:func:`idle_knobs`), pinned at
    their defaults; both backends share it.  The all-defaults point is
    always in it (first, if the space was cut past it)."""
    knobs = dict((space or SEARCH_SPACE)[family])
    for k in KERNEL_STREAM_KNOBS.get(family, ()) + idle_knobs(family,
                                                              shape_class):
        knobs.pop(k, None)
    defaults = dict(kops.DEFAULT_PARAMS[family])
    keys = sorted(knobs)
    grid = [dict(defaults, **dict(zip(keys, combo)))
            for combo in itertools.product(*(knobs[k] for k in keys))]
    if defaults not in grid:
        grid.insert(0, defaults)
    return grid


def _complete_trees(T: int, M: int, F: int, rng):
    """T perfect binary trees in the (T, M) layout (node i's children
    2i+1, 2i+2), random features and thresholds, every node past the
    realized ones a leaf.  Returns the numpy arrays and the depth."""
    d = 1
    while 2 ** (d + 2) - 1 <= M:
        d += 1
    n_int = 2 ** d - 1
    feature = rng.integers(0, F, (T, M)).astype(np.int32)
    threshold = rng.normal(0, 1, (T, M)).astype(np.float32)
    child = np.full((T, M, 2), -1, np.int32)
    is_leaf = np.ones((T, M), bool)
    ii = np.arange(n_int)
    child[:, :n_int, 0] = 2 * ii + 1
    child[:, :n_int, 1] = 2 * ii + 2
    is_leaf[:, :n_int] = False
    return feature, threshold, child, is_leaf, d


def make_workloads(M: int = 256, F: int = 8, C: int = 16, T: int = 8,
                   B: int = 1300, seed: int = 0, device=None) -> dict:
    """Fixed-seed inputs of every tunable family, built with numpy.

    As a forest passes them: T trees of M nodes, their (T*M, F, C) tables
    folded along the table axis, B rows routed as T*B folded rows (row r
    reads ``X[r % B]``).  B = 1300 sits just past 1024; the tables mix
    empty, single and populated bins; an eighth of the table rows attempt.
    ``device``: where the tensors live (the card if one is visible).
    Returns the inputs and each family's shape class."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    rng = np.random.default_rng(seed)
    N = T * M
    n = rng.poisson(4.0, (N, F, C)).astype(np.float32)
    mean = np.where(n > 0, rng.normal(0, 1, (N, F, C)), 0).astype(np.float32)
    m2 = np.where(n > 1, rng.gamma(2.0, 1.0, (N, F, C)), 0).astype(np.float32)
    sum_x = np.where(n > 0, rng.normal(0, 1, (N, F, C)), 0).astype(np.float32)
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    y = rng.normal(0, 1, (B,)).astype(np.float32)
    leaf = (np.arange(T, dtype=np.int32).repeat(B) * M
            + rng.integers(0, M, T * B)).astype(np.int32)
    attempt = np.arange(N) < max(1, N // 8)
    feature, threshold, child, is_leaf, depth = _complete_trees(T, M, F, rng)
    t = lambda a: torch.as_tensor(a, device=dev)
    ao_y = {"n": t(n), "mean": t(mean), "m2": t(m2)}
    ao_sum_x = t(sum_x)
    X_ = t(X)
    tabs = kops._shape_class_tables(N, F, C)
    return {
        "query": (ao_y, ao_sum_x, t(attempt)),
        "route": (t(feature), t(threshold), t(child), t(is_leaf), X_),
        "merge": (ao_y, ao_sum_x, ao_y, ao_sum_x),
        # the sketch families read the same planes with C as K slots (the
        # compaction sorts them into rank order itself)
        "sketch_update": (ao_y, ao_sum_x, t(leaf), X_, t(y)),
        "sketch_merge": (ao_y, ao_sum_x, ao_y, ao_sum_x),
        "depth": depth,
        "shape_class": {
            "forest_query": tabs, "forest_merge": tabs,
            "sketch_update": tabs, "sketch_merge": tabs,
            "forest_route": kops._shape_class_route(T, M, F),
        },
    }


def _runner(family: str, w: dict, backend: str):
    """Zero-argument closure running ``family`` once through its public
    op, with no explicit knob: the installed tuning entry, and nothing
    else, steers it.  ``backend`` must match the workload's device."""
    dev_backend = kops.backend_of(w["merge"][1])
    if resolve_backend(backend) != dev_backend:
        raise ValueError(f"the workload lives on {dev_backend}, not "
                         f"{backend}")
    if family == "forest_query":
        return lambda: kops.forest_best_splits(*w["query"])
    if family == "forest_route":
        return lambda: kops.forest_route(*w["route"], depth=w["depth"])
    if family == "forest_merge":
        return lambda: kops.forest_merge(*w["merge"])
    if family == "sketch_update":
        return lambda: kops.sketch_update(*w["sketch_update"])
    if family == "sketch_merge":
        return lambda: kops.sketch_merge(*w["sketch_merge"])
    raise KeyError(family)


@contextlib.contextmanager
def _only_tuning(entry: dict):
    """Temporarily replace the process's tuning table."""
    saved = kops.get_tuning()
    try:
        kops.set_tuning(entry)
        yield
    finally:
        kops.set_tuning(saved)


def _leaves(out) -> list:
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _snapshot(out) -> list:
    """The output's tensors, copied (a scratch table is reused)."""
    return [t.detach().clone() for t in _leaves(out)]


def _bits(t):
    """A tensor's bits with every NaN made one NaN (NaN equals NaN)."""
    if t.is_floating_point():
        t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def _bitwise_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _sync(on_card):
    if on_card:
        torch.cuda.synchronize()


def _time(run, inner: int, on_card: bool, kernel: str):
    """``(host us, event us, device us)`` a call over ``inner``
    back-to-back calls (the last two None on the CPU); the device time is
    that of the kernels whose names start with ``kernel``."""
    _sync(on_card)
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(inner):
        run()
    if on_card:
        end.record()
    _sync(on_card)
    host = (time.perf_counter() - t0) / inner * 1e6
    if not on_card:
        return host, None, None
    event = start.elapsed_time(end) / inner * 1e3
    return host, event, _kernel_us(
        profile.device_times(run, reps=inner, warm=False), kernel)


def _kernel_us(times: dict, kernel: str) -> float:
    """Device us a call of the kernels in ``times`` (``{profiler key: ms
    a call}``, :func:`repro_torch.perf.profile.device_times`) whose names
    start with ``kernel``; a key such as ``void qo_route_kernel<256,
    true>(...)`` is read without its return type.  Raises if there is
    none: the knob's kernel did not run."""
    mine = [ms for key, ms in times.items()
            if key.removeprefix("void ").startswith(kernel)]
    if not mine:
        raise RuntimeError(f"the profiler recorded no {kernel} kernel: "
                           f"{sorted(times)}")
    return sum(mine) * 1e3


def tune_family(family: str, backend: str | None = None, *,
                shapes: dict | None = None, space: dict | None = None,
                reps: int = 3, inner: int = 2,
                workloads: dict | None = None) -> tuple[str, dict]:
    """Race the family's grid on one workload; returns ``(cache key,
    entry)``.

    Each candidate first runs once under its own tuning table and must be
    bitwise equal to the all-defaults output (:class:`TuningError`
    otherwise); then ``reps`` interleaved rounds of ``inner`` calls each,
    keeping each candidate's best round.  The fastest candidate wins if
    it beats the defaults by more than ``spread_us`` (the larger of the
    two's best-to-worst rounds), else the defaults do.  The entry holds
    the winner's params, its time and the default's (``us``,
    ``default_us``: the steered kernel's device time on the card, host
    time on the CPU), the speedup, the spread, the candidate count, and
    the other timings (``host_us``, ``default_host_us``; ``event_us``,
    ``default_event_us`` on the card).  ``workloads``: the inputs of
    :func:`make_workloads`, when the caller built them already.  A family
    with stream knobs alone (``forest_update``, ``qo_update``) has
    nothing to race: ValueError.
    """
    if family not in KERNEL_OF:
        raise ValueError(f"{family}: not a tuned family (its knobs are "
                         f"stream knobs, one compiled value each)"
                         if family in KERNEL_STREAM_KNOBS else family)
    backend = resolve_backend(backend)
    on_card = backend == "cuda"
    defaults = dict(kops.DEFAULT_PARAMS[family])
    w = workloads or make_workloads(
        **(shapes or {}), device="cuda" if on_card else "cpu")
    sc = w["shape_class"][family]
    tkey = (family, backend, sc)
    run = _runner(family, w, backend)
    with _only_tuning({}):
        ref = _snapshot(run())
    grid = candidates(family, space, sc)
    if defaults not in grid:
        raise ValueError(f"{family}: the search space must hold the "
                         f"defaults")
    for cand in grid:                    # the identity gate, before timing
        with _only_tuning({tkey: cand}):
            out = _snapshot(run())
        if not _bitwise_equal(ref, out):
            raise TuningError(
                f"{family}/{backend}/{sc}: candidate {cand} is not "
                f"bit-identical to the defaults -- the schedule changed "
                f"the semantics")
    rounds = [[] for _ in grid]          # (host, event, device) a round
    for _ in range(reps):
        for i, cand in enumerate(grid):
            with _only_tuning({tkey: cand}):
                rounds[i].append(_time(run, inner, on_card,
                                       KERNEL_OF[family]))
    best = [[min(r[j] for r in rs) if rs[0][j] is not None else None
             for j in range(3)] for rs in rounds]
    rank = 2 if on_card else 0
    ranked = [[r[rank] for r in rs] for rs in rounds]
    d = grid.index(defaults)
    win = int(np.argmin([b[rank] for b in best]))
    spread = max(max(ranked[i]) - min(ranked[i]) for i in (d, win))
    if best[d][rank] - best[win][rank] <= spread:
        win = d
    entry = {
        "params": grid[win],
        "us": round(best[win][rank], 3),
        "default_us": round(best[d][rank], 3),
        "speedup_vs_default": round(best[d][rank] / best[win][rank], 4),
        "spread_us": round(spread, 3),
        "n_candidates": len(grid),
        "time": "device" if on_card else "host",
        "host_us": round(best[win][0], 3),
        "default_host_us": round(best[d][0], 3),
    }
    if on_card:
        entry["event_us"] = round(best[win][1], 3)
        entry["default_event_us"] = round(best[d][1], 3)
    return "|".join((device_kind(), family, backend, sc)), entry


def tune(families=TUNE_FAMILIES, backend: str | None = None, *,
         shapes: dict | None = None, space: dict | None = None,
         reps: int = 3, inner: int = 2) -> dict:
    """Tune each family on one shared workload; returns ``{cache key:
    entry}``."""
    backend = resolve_backend(backend)
    w = make_workloads(**(shapes or {}),
                       device="cuda" if backend == "cuda" else "cpu")
    return dict(tune_family(fam, backend, space=space, reps=reps,
                            inner=inner, workloads=w)
                for fam in families)


# --------------------------------------------------------------------------
# persistence + installation
# --------------------------------------------------------------------------

_CACHE_VERSION = 1


def cache_path() -> str:
    """``$REPRO_TORCH_TUNING_CACHE`` if set, else ``.tuning_cache_torch.json``
    at the repo root (ignored by git: one machine's measurement).  The
    reference's tuner keeps its own file, so neither overwrites the
    other's."""
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, ".tuning_cache_torch.json")


def load_cache(path: str | None = None) -> dict:
    """``{cache key: entry}`` from disk ({} for a missing file or another
    version)."""
    path = path or cache_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        blob = json.load(f)
    if blob.get("version") != _CACHE_VERSION:
        return {}
    return blob.get("entries", {})


def save_cache(entries: dict, path: str | None = None) -> str:
    """Merge ``entries`` over the cache on disk and write it back."""
    path = path or cache_path()
    merged = dict(load_cache(path))
    merged.update(entries)
    with open(path, "w") as f:
        json.dump({"version": _CACHE_VERSION, "entries": merged}, f,
                  indent=1, sort_keys=True)
    return path


def install(entries: dict) -> dict:
    """Hand this device kind's entries to :func:`repro_torch.kernels.ops.
    set_tuning` (replacing the installed table); returns the installed
    ``{(family, backend, shape_class): params}``.  Entries of other device
    kinds are dropped."""
    dk = device_kind()
    table = {}
    for key, entry in entries.items():
        kind, family, backend, sc = key.split("|")
        if kind == dk:
            table[(family, backend, sc)] = dict(entry["params"])
    kops.set_tuning(table)
    return table


def ensure(path: str | None = None, families=TUNE_FAMILIES,
           backend: str | None = None, *, shapes: dict | None = None,
           space: dict | None = None, reps: int = 3,
           force: bool = False) -> dict:
    """Load or tune: tune (and save) each family with no entry for this
    device kind and backend, then install the cache."""
    entries = {} if force else load_cache(path)
    rb = resolve_backend(backend)
    have = {k.split("|")[1] for k in entries
            if k.split("|")[0] == device_kind() and k.split("|")[2] == rb}
    missing = [f for f in families if f not in have]
    if missing:
        entries = dict(entries, **tune(missing, rb, shapes=shapes,
                                       space=space, reps=reps))
        save_cache(entries, path)
    install(entries)
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid and shapes; check the cache round trip")
    ap.add_argument("--families", nargs="*", default=list(TUNE_FAMILIES))
    ap.add_argument("--backend", default=None, choices=("cuda", "plain"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cache", default=None,
                    help="cache file (default: $REPRO_TORCH_TUNING_CACHE or "
                         ".tuning_cache_torch.json at the repo root)")
    args = ap.parse_args(argv)

    shapes = SMOKE_SHAPES if args.smoke else None
    space = SMOKE_SPACE if args.smoke else None
    reps = 2 if args.smoke else args.reps
    entries = tune(args.families, args.backend, shapes=shapes, space=space,
                   reps=reps)
    path = save_cache(entries, args.cache)
    reloaded = load_cache(path)
    for key, entry in entries.items():
        if reloaded.get(key) != json.loads(json.dumps(entry)):
            raise RuntimeError(f"cache round trip differs for {key}")
    installed = install(reloaded)
    print(f"tuned {len(entries)} entr{'y' if len(entries) == 1 else 'ies'} "
          f"-> {path} (installed {len(installed)} for '{device_kind()}')")
    for key, entry in sorted(entries.items()):
        print(f"  {key:<60} {entry['us']:>9.3f}us {entry['time']} "
              f"({entry['speedup_vs_default']:.3f}x vs default "
              f"{entry['default_us']:.3f}us, spread "
              f"{entry['spread_us']:.3f}us) {entry['params']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
