"""The port's perf layer: tuned launch shapes, the tuner, the op-cost
counter and the profiler views.

* the cache format and device-kind filter are the reference's
  (``repro.perf.tune``): a cache written by either package loads in the
  other as the same dict, and ``install`` keeps the same entries;
* the op-cost counter gives ``repro.launch.hlocost``'s flops for a matmul,
  a 64-step scan against a 64-pass loop and nested scans against nested
  loops;
* the reference's CPU-side tuner contracts (``tests/test_perf.py``): the
  space holds the defaults, the stream knobs stay out of the grid,
  unknown params are ignored, an explicit argument beats the table, the
  smoke round trip, foreign device kinds are dropped, ``ensure`` tunes
  once, a planted non-identical candidate raises ``TuningError``;
* no fallback: a knob outside a kernel's compiled set raises, as a
  keyword and as an installed entry;
* the race: the update families (stream knobs alone) are not raced, a
  shape class drops the knob of a kernel it never launches, the steered
  kernel's time ranks, and a winner must beat the race's spread;
* ``TestOnCard`` (skipped without a GPU) races every candidate of every
  family through the identity gate on the card, runs the compaction's
  warps where a block takes more than 48 KB, and holds a launch refused
  by the kernel to a raise.

Reference modules are imported inside the CPU tests, so that
``tools_torch/card_tests.py`` can run ``TestOnCard`` without JAX.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import (_build, ops, qo_merge, qo_query_batched,
                                 qo_route, sketch_compact)
from repro_torch.perf import opcost, profile
from repro_torch.perf import tune as ptune

SMALL = dict(M=31, F=3, C=8, T=2, B=200)


@pytest.fixture(autouse=True)
def _untuned():
    """Every test starts and ends with no tuning installed."""
    ops.set_tuning({})
    yield
    ops.set_tuning({})


def _entries(kind):
    return {f"{kind}|forest_merge|plain|M8xF2xC4": {
                "params": {"threads": 512}, "us": 1.5, "default_us": 2.0,
                "speedup_vs_default": 1.3333, "n_candidates": 4},
            f"{kind}|forest_route|cuda|T16xM1023xF16": {
                "params": {"rows": 128}, "us": 5.0, "default_us": 5.4,
                "speedup_vs_default": 1.08, "n_candidates": 3}}


# --------------------------------------------------------------------------
# parity with the reference's tuner and cost walker
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cache_crosses_both_ways(tmp_path, writer):
    from repro.perf import tune as jtune
    path = str(tmp_path / "cache.json")
    entries = dict(_entries("cpu"), **_entries("NVIDIA H100 80GB HBM3"))
    save, load = (jtune.save_cache, ptune.load_cache) if writer == \
        "reference" else (ptune.save_cache, jtune.load_cache)
    save(entries, path)
    assert load(path) == entries
    assert ptune.load_cache(path) == jtune.load_cache(path)
    with open(path) as f:
        assert json.load(f)["version"] == 1


def test_install_keeps_the_same_entries_as_the_reference():
    from repro.kernels import ops as jops
    from repro.perf import tune as jtune
    entries = dict(_entries("cpu"), **_entries("TPU v5e"),
                   **_entries("NVIDIA H100 80GB HBM3"))
    try:
        ref = jtune.install(entries)
    finally:
        jops.set_tuning({})
    assert jtune.device_kind() == ptune.device_kind() == "cpu"
    assert ptune.install(entries) == ref == {
        ("forest_merge", "plain", "M8xF2xC4"): {"threads": 512},
        ("forest_route", "cuda", "T16xM1023xF16"): {"rows": 128}}
    assert ops.get_tuning() == ref


def _ref_flops(fn, *shapes):
    import jax
    import jax.numpy as jnp
    from repro.launch import hlocost
    comp = jax.jit(fn).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                               for s in shapes)).compile()
    return hlocost.analyze(comp.as_text())["flops"]


def test_opcost_matmul_matches_hlocost():
    a, b = torch.randn(128, 256), torch.randn(256, 64)
    c = opcost.count(lambda: a @ b)
    assert c.flops == _ref_flops(lambda x, y: x @ y, (128, 256), (256, 64)) \
        == 2 * 128 * 256 * 64
    assert c.bytes >= (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_opcost_loop_matches_hlocost_scan():
    import jax
    import jax.numpy as jnp

    def scan(x, w):
        return jax.lax.scan(lambda c, wi: (jnp.tanh(c @ wi), None), x, w)[0]

    x, w = torch.randn(16, 16), torch.randn(64, 16, 16)

    def loop():
        c = x
        for i in range(64):
            c = torch.tanh(c @ w[i])
        return c

    assert opcost.count(loop).flops == _ref_flops(scan, (16, 16),
                                                  (64, 16, 16)) \
        == 64 * 2 * 16 ** 3


def test_opcost_nested_loops_match_hlocost_nested_scans():
    import jax
    import jax.numpy as jnp

    def nested(x, w):
        def outer(c, wi):
            inner = lambda c2, _: (jnp.tanh(c2 @ wi), None)
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, w)[0]

    x, w = torch.randn(32, 32), torch.randn(4, 32, 32)

    def loops():
        c = x
        for i in range(4):
            for _ in range(3):
                c = torch.tanh(c @ w[i])
        return c

    assert opcost.count(loops).flops == _ref_flops(nested, (32, 32),
                                                   (4, 32, 32)) \
        == 4 * 3 * 2 * 32 ** 3


# --------------------------------------------------------------------------
# the op-cost counter and the profiler views
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,fn,flops", [
    ("bmm", lambda: torch.bmm(torch.ones(2, 3, 4), torch.ones(2, 4, 5)),
     2 * 2 * 3 * 5 * 4),
    ("addmm", lambda: torch.addmm(torch.ones(3, 5), torch.ones(3, 4),
                                  torch.ones(4, 5)), 2 * 3 * 5 * 4),
    ("mv", lambda: torch.mv(torch.ones(3, 4), torch.ones(4)), 2 * 3 * 4),
    ("dot", lambda: torch.dot(torch.ones(7), torch.ones(7)), 2 * 7)])
def test_opcost_matmul_class_flops(name, fn, flops):
    c = opcost.count(fn)
    assert c.by_op[name][1] == c.flops == flops


def test_opcost_charges_bytes_by_class():
    a = torch.ones(100)
    idx = torch.arange(10)
    c = opcost.count(lambda: a + a)          # one operand, once, and result
    assert c.bytes == 800 and c.flops == 0
    c = opcost.count(lambda: a.view(10, 10).t())
    assert c.bytes == 0                      # views move nothing
    c = opcost.count(lambda: a.view(10, 10).t().reshape(100))
    assert c.bytes == 800                    # a copy reads and writes once
    c = opcost.count(lambda: a[idx])         # reads only what it produces
    assert c.by_op["index"][2] == 80
    b = torch.zeros(100)
    c = opcost.count(lambda: b.index_add_(0, idx, torch.ones(10)))
    assert c.by_op["index_add_"][2] == 2 * 40 + 80


def test_opcost_charges_kernel_launches():
    """A kernel launch reaches the counter through ``_build.launched``
    with its module's cost, and counts as one launch."""
    before = dict(_build.LAUNCHES)
    try:
        with opcost.OpCounter() as c:
            _build.launched("qo_merge", lambda: qo_merge.cost(1000))
            _build.launched("qo_route",
                            lambda: qo_route.cost(2, 15, 10, 3, 4))
        assert c.by_op["qo_merge"] == [1, 14000.0, 48000.0]
        assert c.by_op["qo_route"] == [1, 2 * 2 * 10 * 4,
                                       2 * 15 * 17 + 10 * 3 * 4 + 2 * 10 * 4]
        assert c.flops == 14000 + 160 and "cuda" in c.devices
        assert _build.LAUNCHES["qo_merge"] == before["qo_merge"] + 1
    finally:
        _build.LAUNCHES.update(before)
    assert not _build.COST_SINKS


def test_a_launch_cost_reads_are_not_charged():
    """A cost that reads the launch's data (a host read on the card) runs
    with the counter paused: only the launch itself is charged."""
    before = dict(_build.LAUNCHES)
    try:
        with opcost.OpCounter() as c:
            _build.launched("qo_merge",
                            lambda: (int(torch.ones(10).sum()) * 4, 0))
        assert dict(c.by_op) == {"qo_merge": [1, 0.0, 40.0]}
        assert c.bytes == 40.0
    finally:
        _build.LAUNCHES.update(before)


def test_kernel_costs_are_the_bound_formulas():
    assert qo_query_batched.cost(3, 16, 64) == (
        3 * 16 * 64 * 16 + 3 * 4 + 3 * 16 * 8, 3 * 16 * 64 * 30)
    assert sketch_compact.cost(10, 32, 16) == (10 * 32 * 16 + 10 * 16 * 16,
                                               10 * 32 * 20)
    assert qo_route.cost(2, 15, 10, 3, 4, nodes=7, walked=9) == (
        7 * 17 + 10 * 3 * 4 + 2 * 10 * 4, 18)
    assert profile.bound(3.35e9, 0) == (1.0, "bytes")
    assert profile.bound(0, 67e9) == (1.0, "operations")


def test_op_costs_on_the_cpu():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    costs = profile.op_costs(lambda x, y: x @ y, a, b)
    assert costs["flops"] == 2 * 8 * 16 * 4
    assert costs["bytes"] == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert costs["peak_memory"] == 0.0 and costs["optimal_seconds"] == 0.0


def test_op_costs_of_a_forest_step_leave_it_unchanged():
    """Counting a real step (the learn path's ops, no card here) charges
    its traffic and gives the same state as the uncounted step."""
    from repro_torch.core import forest as tfr
    from repro_torch.core import hoeffding as tht
    cfg = tfr.ForestConfig(tree=tht.HTRConfig(n_features=3, max_nodes=15,
                                              n_bins=8, grace_period=20,
                                              max_depth=3), n_trees=2)
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    y = X[:, 0] * 2 + torch.tensor(rng.normal(size=64), dtype=torch.float32)
    out = []
    costs = profile.op_costs(lambda: out.append(tfr.update(
        cfg, tfr.init_forest(cfg, 3, device="cpu"), X, y, device="cpu")))
    plain, _ = tfr.update(cfg, tfr.init_forest(cfg, 3, device="cpu"), X, y,
                          device="cpu")
    counted = out[0][0]
    for k in ("feature", "threshold", "n_nodes"):
        assert torch.equal(counted["trees"][k], plain["trees"][k])
    assert torch.equal(counted["trees"]["ao_y"]["m2"],
                       plain["trees"]["ao_y"]["m2"])
    assert costs["bytes"] > X.numel() * 4
    assert costs["peak_memory"] == 0.0 and costs["optimal_seconds"] == 0.0


def test_trace_profile_ops_and_report(tmp_path):
    a = torch.randn(8, 16)
    with profile.trace(str(tmp_path / "tr")) as logdir:
        torch.mm(a, a.T)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert logdir == str(tmp_path / "tr") and len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "aten::mm" in names
    report = profile.profile_ops({"mm": (torch.mm, (a, a.T))},
                                 logdir=str(tmp_path / "tr"))
    assert report["mm"]["flops"] == 2 * 8 * 8 * 16
    assert len(list((tmp_path / "tr").glob("trace_*.json"))) == 2
    path = profile.write_report(report, str(tmp_path / "r.json"))
    assert json.loads(open(path).read()) == report


# --------------------------------------------------------------------------
# the tuning hooks and the tuner (the reference's CPU-side contracts)
# --------------------------------------------------------------------------

def test_search_space_contains_defaults():
    assert set(ptune.SEARCH_SPACE) == set(ops.DEFAULT_PARAMS)
    for family, knobs in ptune.SEARCH_SPACE.items():
        defaults = ops.DEFAULT_PARAMS[family]
        assert set(knobs) == set(defaults), family
        for k, v in defaults.items():
            assert v in knobs[k], (family, k)
        assert defaults in ptune.candidates(family)


def test_kernel_stream_knobs_held_out_of_the_cuda_grid():
    """Every stream knob has one compiled value, and the grid (the cuda
    and the plain backend's) never varies it; the launch knobs' grids are
    their whole compiled sets."""
    for family, pinned in ptune.KERNEL_STREAM_KNOBS.items():
        for knob in pinned:
            default = ops.DEFAULT_PARAMS[family][knob]
            assert tuple(ptune.SEARCH_SPACE[family][knob]) == (default,)
            assert {c[knob] for c in ptune.candidates(family)} == \
                {default}, (family, knob)
    assert {c["rows"] for c in ptune.candidates("forest_route")} == \
        set(qo_route.ROWS_CHOICES)
    assert len(ptune.candidates("sketch_merge")) == 9
    assert ptune.SMOKE_SPACE["forest_merge"]["threads"] == (128, 1024)


def test_tuned_unknown_params_ignored():
    ops.set_tuning({("forest_merge", "plain", "X"): {"bogus": 7,
                                                      "threads": 128}})
    assert ops.tuned("forest_merge", "plain", "X") == {"threads": 128}
    assert ops.tuned("forest_merge", "cuda", "X") == {"threads": 256}


def test_explicit_argument_beats_the_table(monkeypatch):
    """An installed entry steers the kernel's launch shape, an explicit
    keyword beats it, None leaves the table's."""
    seen = []
    real = qo_route.forest_route

    def spy(*a, rows):
        seen.append(rows)
        return real(*a, rows=rows)

    monkeypatch.setattr(qo_route, "forest_route", spy)
    w = ptune.make_workloads(**SMALL, device="cpu")
    route = lambda **k: ops.forest_route(*w["route"], depth=w["depth"], **k)
    ref = route()
    ops.set_tuning({("forest_route", "plain",
                     w["shape_class"]["forest_route"]): {"rows": 512}})
    assert torch.equal(route(), ref)
    assert torch.equal(route(rows=128), ref)
    assert torch.equal(route(rows=None), ref)
    assert seen == [256, 512, 128, 512]
    assert ops.tuned("forest_route", "plain",
                     w["shape_class"]["forest_route"], rows=128) == \
        {"rows": 128}


@pytest.mark.parametrize("family", ptune.TUNE_FAMILIES)
def test_every_candidate_bit_identical_on_plain(family):
    """The plain versions never see a knob: the gate passes every
    candidate of every tuned family (and the runners reach every op)."""
    key, entry = ptune.tune_family(family, "plain", shapes=SMALL, reps=1,
                                   inner=1)
    sc = ptune.make_workloads(**SMALL, device="cpu")["shape_class"][family]
    assert key.split("|") == ["cpu", family, "plain", sc]
    assert entry["n_candidates"] == len(ptune.candidates(family,
                                                         shape_class=sc))
    assert entry["time"] == "host" and entry["us"] > 0


@pytest.mark.parametrize("family", sorted(ptune.KERNEL_STREAM_KNOBS))
def test_stream_knob_families_are_not_raced(family):
    """The update families have stream knobs alone: one candidate, no
    race, and no keyword on their ops."""
    import inspect
    assert family not in ptune.TUNE_FAMILIES
    assert len(ptune.candidates(family)) == 1
    with pytest.raises(ValueError, match="stream knobs"):
        ptune.tune_family(family, "plain", shapes=SMALL, reps=1, inner=1)
    params = inspect.signature(getattr(ops, family)).parameters
    assert not set(ptune.KERNEL_STREAM_KNOBS[family]) & set(params)


@pytest.mark.parametrize("K,raced", [(8, "warps"), (16, "warps"),
                                     (17, "gen_warps"), (64, "gen_warps")])
def test_grid_drops_the_knob_of_a_kernel_never_launched(K, raced):
    """A sketch family's compaction of 2K centroids runs the fast kernel
    (``warps``) up to K = 16 and the general one (``gen_warps``) past it:
    only the launched kernel's knob is raced."""
    idle = ({"warps", "gen_warps"} - {raced}).pop()
    assert sketch_compact.fast_kernel(2 * K, K) == (raced == "warps")
    for family in ("sketch_update", "sketch_merge"):
        grid = ptune.candidates(family, shape_class=f"M63xF5xC{K}")
        assert ptune.idle_knobs(family, f"M63xF5xC{K}") == (idle,)
        assert {c[idle] for c in grid} == {ops.DEFAULT_PARAMS[family][idle]}
        assert {c[raced] for c in grid} == \
            set(ptune.SEARCH_SPACE[family][raced])
    assert ptune.idle_knobs("forest_merge", f"M63xF5xC{K}") == ()


def test_race_ranks_the_steered_kernel_alone():
    """The device time that ranks is the knob's kernel's: the other
    kernels of the op (a pre-sketch, a row compaction) are left out, and
    a profile without the kernel raises."""
    times = {"void qo_merge_vec_kernel<256>(float const*)": 0.002,
             "qo_merge_scalar_kernel<256>": 0.001,
             "void at::native::elementwise_kernel<128, 4>(int)": 1.0}
    assert ptune._kernel_us(times, "qo_merge") == pytest.approx(3.0)
    with pytest.raises(RuntimeError, match="no qo_route kernel"):
        ptune._kernel_us(times, "qo_route")
    csrc = ops.__file__.rsplit("/", 2)[0] + "/csrc/"
    for family, kernel in ptune.KERNEL_OF.items():
        with open(csrc + kernel + ".cu") as f:
            src = f.read()
        assert f" {kernel}_" in src and "__global__" in src, family


@pytest.mark.parametrize("faster,wins", [(9.0, False), (5.0, True)])
def test_a_winner_must_beat_the_spread(monkeypatch, faster, wins):
    """The defaults' rounds spread over 4 us: a candidate 1 us faster is
    noise and the defaults stay; one 5 us faster wins."""
    w = ptune.make_workloads(**SMALL, device="cpu")
    sc = w["shape_class"]["forest_merge"]
    rounds = {256: iter([10.0, 14.0]), 128: iter([faster, faster])}

    def planted(run, inner, on_card, kernel):
        threads = ops.tuned("forest_merge", "plain", sc)["threads"]
        return next(rounds.get(threads, iter([99.0, 99.0]))), None, None

    monkeypatch.setattr(ptune, "_time", planted)
    _, entry = ptune.tune_family(
        "forest_merge", "plain", space={"forest_merge": {
            "threads": (128, 256)}}, reps=2, inner=1, workloads=w)
    assert entry["spread_us"] == 4.0 and entry["default_us"] == 10.0
    assert entry["params"] == {"threads": 128 if wins else 256}
    assert entry["us"] == (faster if wins else 10.0)


def test_tuner_smoke_cache_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    key, entry = ptune.tune_family("forest_merge", "plain",
                                   shapes=ptune.SMOKE_SHAPES,
                                   space=ptune.SMOKE_SPACE, reps=1, inner=1)
    assert entry["params"] in ptune.candidates("forest_merge",
                                               ptune.SMOKE_SPACE)
    assert entry["speedup_vs_default"] > 0
    ptune.save_cache({key: entry}, path)
    reloaded = ptune.load_cache(path)
    assert reloaded == {key: json.loads(json.dumps(entry))}
    installed = ptune.install(reloaded)
    fam, bk, sc = key.split("|")[1:]
    assert installed == {(fam, bk, sc): entry["params"]}
    assert ops.get_tuning() == installed


def test_main_smoke_writes_the_cache(tmp_path, capsys):
    path = str(tmp_path / "cache.json")
    assert ptune.main(["--smoke", "--cache", path, "--families",
                       "forest_route", "forest_query"]) == 0
    assert sorted(k.split("|")[1] for k in ptune.load_cache(path)) == \
        ["forest_query", "forest_route"]
    assert "installed 2 for 'cpu'" in capsys.readouterr().out


def test_cache_path_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    assert ptune.cache_path().endswith(".tuning_cache_torch.json")
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "c.json"))
    assert ptune.cache_path() == str(tmp_path / "c.json")
    assert ptune.load_cache() == {}


def test_install_filters_foreign_device_kinds():
    alien = "not-a-real-device|forest_merge|plain|M8xF2xC4"
    table = ptune.install({alien: {"params": {"threads": 128}}})
    assert table == {} and ops.get_tuning() == {}


def test_ensure_tunes_once_then_loads(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    calls = []
    real = ptune.tune

    def counting_tune(families, *a, **kw):
        calls.append(tuple(families))
        return real(families, *a, **kw)

    monkeypatch.setattr(ptune, "tune", counting_tune)
    kw = dict(families=("forest_merge",), backend="plain",
              shapes=ptune.SMOKE_SHAPES, space=ptune.SMOKE_SPACE, reps=1)
    ptune.ensure(path, **kw)
    assert calls == [("forest_merge",)]
    ops.set_tuning({})
    ptune.ensure(path, **kw)             # a cache hit: no second race
    assert calls == [("forest_merge",)]
    assert ops.get_tuning() != {}


def test_planted_non_identical_candidate_raises(monkeypatch):
    """A schedule that moves one bit is refused before any timing."""
    real = qo_merge.merge

    def off_by_an_ulp(*planes, threads):
        out = real(*planes, threads=threads)
        if threads != qo_merge.THREADS:
            out = (torch.nextafter(out[0], torch.tensor(np.inf)),) + out[1:]
        return out

    monkeypatch.setattr(qo_merge, "merge", off_by_an_ulp)
    with pytest.raises(ptune.TuningError, match="not bit-identical"):
        ptune.tune_family("forest_merge", "plain", shapes=SMALL, reps=1,
                          inner=1)


def test_bitwise_gate_takes_nan_as_equal():
    a = torch.tensor([1.0, float("nan"), 0.0])
    b = torch.tensor([1.0, -float("nan"), 0.0])
    assert ptune._bitwise_equal([a], [b])
    assert not ptune._bitwise_equal([a], [torch.tensor([1.0, 0.0, 0.0])])
    assert not ptune._bitwise_equal([a], [torch.tensor([1.0, float("nan"),
                                                        -0.0])])


_OUT_OF_SET = [
    ("forest_route", "rows", 100),
    ("forest_query", "warps", 3),
    ("forest_merge", "threads", 200),
    ("sketch_merge", "warps", 5),
    ("sketch_update", "gen_warps", 16),
    ("sketch_update", "warps", 2),
    ("forest_merge", "threads", 64),
]


def _call(family, w, **knob):
    if family == "forest_route":
        return ops.forest_route(*w["route"], depth=w["depth"], **knob)
    if family == "forest_query":
        return ops.forest_best_splits(*w["query"], **knob)
    return {"forest_merge": ops.forest_merge,
            "sketch_merge": ops.sketch_merge,
            "sketch_update": ops.sketch_update}[family](*w[
                "merge" if family != "sketch_update" else family], **knob)


@pytest.mark.parametrize("family,knob,value", _OUT_OF_SET)
def test_knob_outside_the_compiled_set_raises(family, knob, value):
    """No quiet clamp to the default: as a keyword and as an installed
    entry, a value the kernel was not compiled for raises ValueError
    (here on the CPU, before the plain version runs)."""
    w = ptune.make_workloads(**SMALL, device="cpu")
    with pytest.raises(ValueError, match=f"{knob} = {value}"):
        _call(family, w, **{knob: value})
    ops.set_tuning({(family, "plain", w["shape_class"][family]):
                    {knob: value}})
    with pytest.raises(ValueError, match="is not compiled"):
        _call(family, w)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """The tuner's grid on the card: every candidate bitwise equal to the
    defaults, the compaction past 48 KB of shared memory, and a launch the
    kernel refuses raising."""

    @pytest.mark.parametrize("family", ptune.TUNE_FAMILIES)
    @pytest.mark.parametrize("shapes", [
        SMALL, dict(M=63, F=5, C=16, T=3, B=512),
        dict(M=63, F=16, C=64, T=4, B=512)], ids=["C8", "C16", "C64"])
    def test_every_candidate_bitwise(self, card, family, shapes):
        """The identity gate of :func:`tune_family` over the whole grid
        (C = 64 sends the sketch families to the general compaction
        kernel, J = 128); timings come back from all three clocks."""
        key, entry = ptune.tune_family(family, "cuda", shapes=shapes,
                                       reps=1, inner=2)
        assert entry["n_candidates"] == len(ptune.candidates(
            family, shape_class=key.split("|")[3]))
        assert entry["time"] == "device" and entry["us"] > 0
        assert entry["event_us"] > 0 and entry["host_us"] > 0
        assert key.startswith(torch.cuda.get_device_name() + "|")

    @pytest.mark.parametrize("J,K", [(32, 32), (24, 20), (32, 16),
                                     (96, 48), (512, 256)])
    def test_compaction_warps_past_48k(self, card, J, K):
        """Both compaction kernels at every compiled warp count, bitwise
        equal to the defaults: (32, 32) puts 64 KB in a 16-warp block of
        the fast kernel, (512, 256) 80 KB in an 8-warp block of the
        general one."""
        gen = torch.Generator().manual_seed(J * K)
        R = 1000
        n = torch.randint(0, 5, (R, J), generator=gen).float()
        planes = [t.to(card).contiguous() for t in (
            n, torch.randn(R, J, generator=gen) * (n > 0),
            torch.rand(R, J, generator=gen) * (n > 1),
            torch.randn(R, J, generator=gen) * (n > 0))]
        half = [p[:, :J // 2].contiguous() for p in planes], \
            [p[:, J // 2:].contiguous() for p in planes]
        ref = sketch_compact.compact_kernel(planes, K)
        ref2 = sketch_compact.compact_kernel(*half[:1], K, half[1])
        for warps in sketch_compact.WARPS_CHOICES:
            for gw in sketch_compact.GEN_WARPS_CHOICES:
                out = sketch_compact.compact_kernel(planes, K, warps=warps,
                                                    gen_warps=gw)
                out2 = sketch_compact.compact_kernel(
                    half[0], K, half[1], warps=warps, gen_warps=gw)
                assert ptune._bitwise_equal(list(ref), list(out))
                assert ptune._bitwise_equal(list(ref2), list(out2))

    def test_refused_launch_raises(self, card):
        """A value past the wrapper's check is refused by the kernel's
        launcher, and the error is raised, not ignored."""
        w = ptune.make_workloads(**SMALL, device=card)
        feature, threshold, child, is_leaf, X = w["route"]
        out = torch.empty((feature.shape[0], X.shape[0]), dtype=torch.int32,
                          device=card)
        rc = qo_route._launcher()(
            feature.data_ptr(), threshold.data_ptr(), child.data_ptr(),
            is_leaf.data_ptr(), X.data_ptr(), out.data_ptr(),
            feature.shape[0], feature.shape[1], X.shape[0], X.shape[1],
            w["depth"], 100, torch.cuda.current_stream().cuda_stream)
        assert rc != 0
        with pytest.raises(RuntimeError, match="qo_route"):
            _build.check(rc, "qo_route")
        with pytest.raises(ValueError, match="rows = 100"):
            ops.forest_route(*w["route"], depth=w["depth"], rows=100)
