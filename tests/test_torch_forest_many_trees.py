"""A forest of 64 trees on the port: the benchmark's cell
``arf_qo_t64_m4095_f16_c64.friedman_gra_4checks`` (River's
``ARFRegressor`` with ``n_models=64`` on the drifting Friedman stream).

On the CPU the cell keeps its 64 members; the scale is cut (M = 255,
depth 7, C = 16, B = 256, a 60-batch first concept on a 64-batch pool)
so that the port's plain path learns it, swaps members and splits
leaves, and the benchmark's own judging (``perfbench/run.py::run_cell``
against the plain reference ``perfbench/reference/arf.py``, under the
cell's limits) holds it.  A swap step records its fresh members' build
as the span ``forest.fresh`` inside ``forest.swap`` and counts its bytes
as ``forest.fresh_bytes``, and gives the same state bit for bit with the
profiler on and off.  The cell's three per-layer readers are checked on
made-up windows.

On the card (skipped without CUDA): the route kernel at T = 64 and
M = 4,095 (65.5 KB of node records a tree, past the 48 KB default, so the
opt-in shared-memory instance), and at an M whose records pass the opt-in
limit (read from global memory), against the plain route; and a swap
step of the full-size forest (T = 64, M = 4,095), bitwise alike with the
profiler on and off.  This module imports no JAX, so it runs on a card
machine with ``--noconftest``.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as tprofile

from repro_torch.kernels import qo_route
from repro_torch.perf import spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "perfbench") not in sys.path:
    sys.path.insert(0, str(ROOT / "perfbench"))

CELL = "arf_qo_t64_m4095_f16_c64.friedman_gra_4checks"
SMALL = dict(max_nodes=255, max_depth=7, n_bins=16, batch_rows=256)
# The drift test's bar (the decayed window's mean + 3 sd) comes down from
# the first batches' errors only after about 55 batches of one concept, so
# the first concept lasts 60 batches: set-up learns them all and the
# window's step 0, which every window runs however slow the host, is the
# first of the second concept and the kept steps' one (with this seed).
# The carried comparison reruns the first 4 steps, the first splits among
# them.
TRAFFIC = dict(pool_batches=64, period_batches=60, warm_batches=60, carry_steps=4,
               check_every=2, max_checks=1, change_checks=1)
SEED = 2 ** 31 + 6


def t64_cell(**config):
    """The cell's configuration and traffic, ``config`` changed."""
    from harness import spec
    cell = spec.load(CELL, ROOT)
    assert cell.config["n_trees"] == 64
    cell.config.update(**config)
    return cell


def small_cell(**config):
    cell = t64_cell(**{**SMALL, **config})
    cell.traffic.update(TRAFFIC)
    return cell


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix: tree}


def first_swap(loop):
    """Learn until a step swaps a member; that step's batch index and
    pre-step state."""
    from harness import port
    for _ in range(loop.P):
        pre = port.clone(loop.state)
        _, aux, _, _ = loop.step()
        if bool(aux["drift"].any()):
            return loop.pos - 1, pre
    pytest.fail(f"no swap in the pool's {loop.P} batches")


def update_on_and_off(loop, i, pre, activities):
    """The step on batch ``i`` from ``pre``, without and under a profiler:
    the two flattened (state, aux) and the profiler's events."""
    from harness import port
    X, y, bw, nm = loop.batch(i)
    off, aux_off = port.update(loop.fcfg, port.clone(pre), X, y, bw, nm, loop.device)
    with tprofile(activities=activities) as prof:
        on, aux_on = port.update(loop.fcfg, port.clone(pre), X, y, bw, nm, loop.device)
        if torch.device(loop.device).type == "cuda":
            torch.cuda.synchronize(loop.device)
    return flat({"s": off, "a": aux_off}), flat({"s": on, "a": aux_on}), prof.events()


def nbytes(tree):
    return sum(v.nbytes for v in flat(tree).values())


def assert_bitwise(f0, f1):
    assert f0.keys() == f1.keys()
    for key in f0:
        assert torch.equal(f0[key], f1[key]), key


def assert_fresh_inside_swap(events):
    """One ``forest.fresh`` span on the host, inside the ``forest.swap``
    span (a CUDA trace repeats each span on the device's timeline)."""
    host = [e for e in events if e.device_type == DeviceType.CPU]
    fresh = [e for e in host if e.name == "forest.fresh"]
    swap = [e for e in host if e.name == "forest.swap"]
    assert len(fresh) == 1 and len(swap) == 1, [e.name for e in host if "forest." in e.name]
    f, s = fresh[0].time_range, swap[0].time_range
    assert s.start <= f.start <= f.end <= s.end


def test_t64_forest_correct_on_the_cpu_with_a_judged_swap(monkeypatch):
    import run as bench
    from harness import learn
    cell = small_cell()
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{CELL}.json").read_text())
    assert learn.window_checks(cell.traffic, SEED) == {0}
    # the spans and counters live as under a profiler, without its cost
    monkeypatch.setattr(spans, "_recording", lambda: True)
    spans.reset_counts()
    info = {}
    res = bench.run_cell(cell, SEED, 0.1, False, "cpu", time.time(), limits, info)
    assert res["correct"], (res["checks"], info)
    assert info["window_swap_steps"] > 0 and info["split_steps"] > 0, info
    c = spans.counts()
    assert c["forest.swaps"] > 0
    # a swap builds all 64 fresh members: the forest's whole tree state
    members = learn.Loop(cell, SEED, "cpu").state["trees"]
    assert c["forest.fresh_bytes"] == c["forest.swaps"] * nbytes(members)


def test_t64_swap_step_spans_its_fresh_members_and_is_bitwise_with_the_profiler():
    from harness import learn
    # smaller trees than the judged run's: the swap comes at the same step
    loop = learn.Loop(small_cell(max_nodes=63, max_depth=5, batch_rows=128), SEED, "cpu")
    i, pre = first_swap(loop)
    spans.reset_counts()
    f0, f1, events = update_on_and_off(loop, i, pre, [ProfilerActivity.CPU])
    assert_bitwise(f0, f1)
    assert_fresh_inside_swap(events)
    assert spans.counts()["forest.swaps"] == 1
    assert spans.counts()["forest.fresh_bytes"] == nbytes(pre["trees"])


def test_t64_untraced_swap_counts_nothing():
    from harness import learn
    loop = learn.Loop(small_cell(max_nodes=63, max_depth=5, batch_rows=128), SEED, "cpu")
    spans.reset_counts()
    first_swap(loop)
    assert spans.counts() == {}


# --------------------------------------------------------------------------
# the cell's per-layer readers, on made-up windows
# --------------------------------------------------------------------------

def reader(name):
    from harness import spec
    return spec.reader(name, ROOT)


def window(device=(), host=()):
    from harness import trace
    return trace.Trace(window_us=1e6, device=list(device), host=list(host))


@pytest.mark.parametrize("counters,want", [
    ({"forest.swaps": 2, "forest.fresh_bytes": 2 * 68_046_619 * 64}, 4.354983616),
    ({"forest.swaps": 0, "forest.fresh_bytes": 0}, None),
    ({"forest.swaps": 3}, None),  # a program without the counter
])
def test_fresh_gb_per_swap_reads_bytes_over_swaps(monkeypatch, counters, want):
    import types
    from harness import stages
    monkeypatch.setattr(stages, "counters", lambda: dict(counters))
    got = reader("drift_swap.fresh_gb_per_swap")(types.SimpleNamespace(kind="learn"))
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("counters,want", [
    ({"forest.steps": 4}, (1200.0 + 600.0) / 1e3 / 4),
    ({}, None),
])
def test_cuda_malloc_ms_per_step_sums_allocator_calls(monkeypatch, counters, want):
    import types
    from harness import stages
    monkeypatch.setattr(stages, "counters", lambda: dict(counters))
    host = [("cudaMalloc", "cuda_runtime", 10.0, 1200.0),
            ("cudaFree", "cuda_runtime", 20.0, 600.0),
            ("cudaLaunchKernel", "cuda_runtime", 30.0, 5.0),
            ("cudaMalloc", "cpu_op", 40.0, 9.0)]
    got = reader("cuda_malloc_ms_per_step.learn")(
        types.SimpleNamespace(kind="learn", trace=window(host=host)))
    assert got == pytest.approx(want) if want is not None else got is None


def test_route_roofline_learn_counts_visited_nodes_and_launches():
    """One tree (a root split over two leaves), four rows: three nodes
    visited, four non-leaf visits; two route launches in one step."""
    import types
    from harness import roofline
    from reference import arf
    trees = {"feature": torch.tensor([[0, 0, 0]], dtype=torch.int32),
             "threshold": torch.tensor([[0.5, 0.0, 0.0]]),
             "child": torch.tensor([[[1, 2], [-1, -1], [-1, -1]]], dtype=torch.int32),
             "is_leaf": torch.tensor([[False, True, True]])}
    X = torch.tensor([[0.1, 0.0], [0.9, 0.0], [0.2, 0.0], [0.3, 0.0]])
    fn = reader("route_roofline.learn")
    assert fn.__globals__["visited"](*trees.values(), X, 2) == (3, 4)
    assert torch.equal(arf.route(*trees.values(), X, 2), torch.tensor([[1, 2, 1, 1]]))
    kernels = [("void qo_route_kernel<128, true>", "kernel", 0.0, 4.0),
               ("qo_route_kernel<128, true>", "kernel", 9.0, 6.0),
               ("qo_update_leaves_pieces", "kernel", 20.0, 50.0)]
    ctx = types.SimpleNamespace(kind="learn", n=1, cfg={"n_trees": 1, "n_features": 2,
                                                        "max_depth": 2},
                                items=[{"i": 0, "trees": trees}], pool={"X": X[None]},
                                trace=window(device=kernels))
    need = 2 * roofline.bound_s(*roofline.route(1, 4, 2, 3, 4))
    assert fn(ctx) == pytest.approx(100.0 * need / 10e-6)
    ctx.trace = window(device=kernels[2:])
    assert fn(ctx) is None


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def random_trees(rng, T, M, F, splits):
    """(feature, threshold, child, is_leaf, depth) of T trees grown by
    ``splits[t]`` random leaf splits each, in the state's layout (children
    at ``n_nodes``, ``n_nodes + 1``; -1 at leaves)."""
    feature = np.zeros((T, M), np.int32)
    thr = np.zeros((T, M), np.float32)
    child = np.full((T, M, 2), -1, np.int32)
    is_leaf = np.ones((T, M), bool)
    depth = np.zeros((T, M), np.int32)
    for t in range(T):
        leaves, n = [0], 1
        for _ in range(splits[t]):
            j = leaves.pop(int(rng.integers(len(leaves))))
            feature[t, j] = rng.integers(F)
            thr[t, j] = rng.random()
            child[t, j] = (n, n + 1)
            is_leaf[t, j] = False
            depth[t, n:n + 2] = depth[t, j] + 1
            leaves += [n, n + 1]
            n += 2
    return feature, thr, child, is_leaf, depth


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """The route's two instances at large tree sizes, and a swap step of
    the full-size forest with the profiler on and off."""

    @pytest.mark.parametrize("T,M", [(64, 4095), (8, 16383)])
    def test_route_kernel_at_many_large_trees(self, card, T, M):
        """M = 4,095: 65.5 KB of records a tree, the opt-in shared-memory
        instance; M = 16,383: 262 KB, past the opt-in limit, the records
        read from global memory.  Leaf ids equal the plain route's."""
        optin = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
        assert 48 * 1024 < 4095 * 16 <= optin < 16383 * 16
        rng = np.random.default_rng(T * M)
        F, B = 16, 4096
        splits = rng.integers(M // 8, M // 2, T)
        feature, thr, child, is_leaf, depth = random_trees(rng, T, M, F, splits)
        trees = [torch.tensor(a, device=card) for a in (feature, thr, child, is_leaf)]
        X = torch.rand((B, F), generator=torch.Generator(card).manual_seed(T + M),
                       device=card)
        plies = int(depth.max())
        k = qo_route.route_kernel(*trees, X, plies)
        p = qo_route.route_plain(*trees, X, plies)
        assert torch.equal(k, p)
        assert int((~is_leaf).sum()) > 0 and bool((k > 0).any())

    def test_swap_step_bitwise_with_the_profiler_on_and_off(self, card):
        """The full-size forest (T = 64, M = 4,095) learns the drifting
        stream until a step swaps a member; that step, from one pre-step
        state, run with the profiler on and off, gives the same state and
        errors bit for bit, and spans its fresh members' build."""
        from harness import learn
        loop = learn.Loop(t64_cell(max_nodes=4095), SEED, card)
        i, pre = first_swap(loop)
        spans.reset_counts()
        f0, f1, events = update_on_and_off(
            loop, i, pre, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        assert_bitwise(f0, f1)
        assert_fresh_inside_swap(events)
        assert spans.counts()["forest.swaps"] == 1
