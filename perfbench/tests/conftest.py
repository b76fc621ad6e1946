"""Put the benchmark's packages and the program on the path, and give the
tests a small cell: the published widths stay, the scale is cut (T = 2,
M = 63, C = 16, B = 256) so that the port's plain CPU path runs it.

``LEARN`` and ``SERVE`` are the cells of ``BENCHMARK.json`` by their
traffic's kind, in file order, so a cell added there gets the small CPU
tests that run over them without an edit here."""
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "perfbench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL = dict(n_trees=2, max_nodes=63, max_depth=5, n_bins=16, batch_rows=256)


def cells_of_kind(kind):
    """The cells whose traffic is of ``kind``, in ``BENCHMARK.json``'s order."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return tuple(w["name"] for w in spec["workloads"] if json.loads(
        (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())["kind"] == kind)


LEARN = cells_of_kind("learn")
SERVE = cells_of_kind("serve")


def small_cell(workload, root=ROOT):
    from harness import spec
    c = spec.load(workload, root)
    c.config.update(SMALL)
    t = c.traffic
    if t["kind"] == "learn":
        t.update(pool_batches=40, warm_batches=min(t["warm_batches"], 10),
                 check_every=4, max_checks=2, carry_steps=14, change_checks=1)
    else:
        t.update(pool_batches=10, warm_batches=10, carry_steps=10, request_rows_max=512,
                 sizes=64, pool_rows=4096, check_every=8)
    return c


def run_small(workload, seed=2 ** 31 + 17, seconds=0.5, control=None, root=ROOT):
    """The cell's result dict, run on the CPU at the small size."""
    import run as bench
    limits = json.loads((root / "perfbench" / "limits" / f"{workload}.json").read_text())
    return bench.run_cell(small_cell(workload, root), seed, seconds, False, "cpu",
                          time.time(), limits)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no CPU mode")
    return "cuda"


T64 = "arf_qo_t64_m4095_f16_c64"
T64_CELL = f"{T64}.friedman_gra_4checks"


def grow_t64(root):
    """Add a configuration of 64 trees of 4,095 nodes and its cell under
    ``friedman_gra_4checks`` to the benchmark tree at ``root`` as a later
    PR would: new files (the configuration, the traffic, the limits) and
    new entries, the only edit to an existing line the cell's name
    appended to ``learn_rows_per_s``'s cells."""
    bench = root / "perfbench"
    cfg = json.loads((bench / "configs" / "arf_qo_t10_m1023_f16_c64.json").read_text())
    cfg.update(
        name=T64, n_trees=64, max_nodes=4095,
        source="River ARFRegressor (max_features='sqrt', lambda_value=6, grace_period=50, "
               "delta=0.01, tau=0.05) with splitter=QOSplitter(), aggregation_method='mean' "
               "and n_models=64",
        deployment="64 QO Hoeffding trees of 4,095 nodes learning a 16-feature stream in "
                   "batches of 4096 rows, one card; 4.3 GB of tables on the device.",
        assumed={"n_features": "house16H's width and the stream's",
                 "precision": "float32, the port's only precision",
                 "n_trees": "64 members, a forest sized to its card rather than River's "
                            "n_models=10",
                 "max_nodes": "4,095 nodes (depth 12) a tree, so that the QO tables, "
                              "T M F C 16 B, are 4.3 GB"})
    del cfg["from_source"]["n_trees"]
    del cfg["departures"]["max_nodes max_depth"]
    cfg["departures"]["max_depth"] = "River grows without a depth limit under a 500 MB memory " \
                                     "budget; the port's trees are fixed arrays, depth 12"
    traffic = json.loads((bench / "traffic" / "friedman_gra.json").read_text())
    traffic.update(max_checks=2, change_checks=2)
    traffic["source"] += "; two regular and two concept-change checks, so that 2 + 2 kept " \
                         "steps' states fit beside the forest"
    files = {
        bench / "configs" / f"{T64}.json": cfg,
        bench / "traffic" / "friedman_gra_4checks.json": traffic,
        bench / "limits" / f"{T64_CELL}.json": json.loads(
            (bench / "limits" / "arf_qo_t10_m1023_f16_c64.friedman_gra.json").read_text()),
    }
    for path, data in files.items():
        assert not path.exists(), path
        path.write_text(json.dumps(data, indent=1))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    conf = {"name": T64, "source": cfg["source"], "file": f"perfbench/configs/{T64}.json",
            "reduced": [], "why": "a forest of 64 trees of 4,095 nodes: 4.3 GB of QO tables, "
                                  "the absorb's bytes and the route's 65.5 KB of nodes a tree"}
    cell = {"name": T64_CELL, "config": T64, "traffic": "friedman_gra_4checks", "chips": 1,
            "why": "the drifting stream at T = 64, M = 4095, B 4096 closed loop, 2 + 2 kept "
                   "steps: the absorb over 4.3 GB of tables; swaps and regrowth queries"}
    spec["configs"].append(conf)
    spec["workloads"].append(cell)
    next(m for m in spec["end_to_end"]
         if m["name"] == "learn_rows_per_s")["workloads"].append(T64_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture
def grown(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``perfbench/``
    without its tests) in ``tmp_path`` that :func:`grow_t64` has grown."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    grow_t64(tmp_path)
    return tmp_path
