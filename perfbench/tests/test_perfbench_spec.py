"""BENCHMARK.json and the files it names keep to the benchmark's rules."""
import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT, LEARN, SERVE, run_small

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def test_top_level_and_entry_keys():
    assert set(SPEC) == KEYS
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}


def test_names_and_units_use_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [r for c in SPEC["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("end_to_end", "per_layer"):
        for m in SPEC[k]:
            assert UNIT.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    for x in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_in_order_and_each_reports_enough():
    assert [w["name"] for w in SPEC["workloads"]] == [LEARN[0], LEARN[1], LEARN[2], SERVE]
    from harness import spec
    for w in SPEC["workloads"]:
        cell = spec.load(w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_per_layer_metric_moves_one_metric_its_cells_report():
    from harness import spec
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        listed = m.get("workloads", [w for w in cells if m["moves"] in
                                     {x["name"] for x in spec.load(w, ROOT).end_to_end}])
        assert listed
        for w in listed:
            cell = spec.load(w, ROOT)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}, (m["name"], w)
            assert m["name"] in {x["name"] for x in cell.per_layer}, (m["name"], w)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configuration_files_and_limits():
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == [] and cfg["assumed"]
        assert (ROOT / cfg["reference"]).exists()
        named = [k for group in (cfg["from_source"], cfg["departures"]) for key in group
                 for k in key.split()] + cfg["assumed"]
        assert all(k in cfg for k in named if k != "leaf_prediction"), named
        assert not set(cfg["assumed"]) & set(named[:-len(cfg["assumed"])])
    for w in SPEC["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((ROOT / "perfbench" / "limits" / f"{w['name']}.json").read_text())
        assert limits and all(v >= 0 for v in limits.values())


def test_configurations_keep_rivers_documented_settings():
    """ARFRegressor's defaults where the port can express them."""
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["n_trees"] == 10 and cfg["lam"] == 6 and cfg["vote"] == "mean"
        assert round(cfg["subspace"] * cfg["n_features"]) == int(cfg["n_features"] ** 0.5)
        assert (cfg["grace_period"], cfg["delta"], cfg["tau"]) == (50, 0.01, 0.05)


def test_command_stays_in_paths():
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    n = 24
    assert 2 + 14 * n * (SPEC["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


FORBIDDEN_CHECK = r"""
import sys, time, json
sys.path[:0] = [{tests!r}, {bench!r}, {src!r}]
import run, control
from harness import check, learn, port, roofline, serve, spec, streams, trace
from reference import arf
for m in json.load(open({spec!r}))["per_layer"]:
    spec.reader(m["name"])
import conftest
conftest.run_small({learn!r}, seconds=0.2)
conftest.run_small({serve!r}, seconds=0.2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_forbidden_module_is_loaded():
    code = FORBIDDEN_CHECK.format(tests=str(ROOT / "perfbench" / "tests"),
                                  bench=str(ROOT / "perfbench"), src=str(ROOT / "src"),
                                  spec=str(ROOT / "BENCHMARK.json"), learn=LEARN[0],
                                  serve=SERVE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, loaded


def test_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'perfbench')!r}]\n"
            "from reference import arf\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" not in loaded and "jax" not in loaded


@pytest.mark.parametrize("workload", [LEARN[1], SERVE])
def test_result_line_keys(workload):
    res = run_small(workload, seconds=0.2)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    assert json.loads(json.dumps(res)) == res


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    """No CUDA device here: the run exits non-zero and prints nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                          "--workload", LEARN[1], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
