"""``BENCHMARK.json`` and the data files it names.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds its settings) and a traffic mix, found by name at
``perfbench/traffic/<traffic>.json``.  A per-layer metric's reader is
``perfbench/metrics/<metric name>.py``.  A cell reports an end-to-end or
per-layer metric if the metric lists the cell under ``workloads``, or
lists no cells and moves (or is) a metric the cell reports.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric, cell):
    return cell in metric["workloads"] if "workloads" in metric else None


def load(workload: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload) in (True, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _reports(m, workload) or (_reports(m, workload) is None
                                          and m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of a per-layer metric's reader file."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
