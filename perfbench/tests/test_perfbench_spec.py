"""BENCHMARK.json and the files it names keep to the benchmark's rules."""
import json
import subprocess
import sys

import pytest

import spec_rules as rules
from conftest import ROOT, LEARN, SERVE, T64, T64_CELL, run_small

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_and_entry_keys():
    assert rules.keys(SPEC, ROOT) == []


def test_names_and_units_use_the_allowed_characters():
    assert rules.names(SPEC, ROOT) == []


def test_cells_in_order_and_each_reports_enough():
    """The accepted cells first and in order; each cell with its files,
    setup_s and another end-to-end metric, and a per-layer metric."""
    assert rules.cells(SPEC, ROOT) == []


def test_per_layer_metric_moves_one_metric_its_cells_report():
    assert rules.per_layer(SPEC, ROOT) == []


def test_configuration_files_and_limits():
    assert rules.configs(SPEC, ROOT) == []


def test_configurations_keep_rivers_documented_settings():
    """ARFRegressor's defaults where the port can express them, or a
    departure named with its reason; the accepted configurations keep
    them."""
    assert rules.river(SPEC, ROOT) == []


def test_command_stays_in_paths():
    assert rules.command(SPEC, ROOT) == []


def _without_t64(spec):
    """``spec`` less the entries :func:`conftest.grow_t64` adds."""
    spec = json.loads(json.dumps(spec))
    spec["configs"] = [c for c in spec["configs"] if c["name"] != T64]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] != T64_CELL]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if T64_CELL in m.get("workloads", []):
            m["workloads"].remove(T64_CELL)
    return spec


def test_a_cell_joins_through_new_files_and_entries(grown):
    """A configuration and its cell added as new files and entries alone
    keep every rule, load and run correct at the small size; nothing
    that was there changed but the appended entries."""
    from harness import spec
    assert rules.check(ROOT) == []
    assert rules.check(grown) == []
    assert _without_t64(json.loads((grown / "BENCHMARK.json").read_text())) == SPEC
    new = []
    for f in (grown / "perfbench").rglob("*.*"):
        old = ROOT / f.relative_to(grown)
        if old.exists():
            assert f.read_bytes() == old.read_bytes(), f
        else:
            new.append(str(f.relative_to(grown)))
    assert sorted(new) == [f"perfbench/configs/{T64}.json",
                           f"perfbench/limits/{T64_CELL}.json",
                           "perfbench/traffic/friedman_gra_4checks.json"]
    cell = spec.load(T64_CELL, grown)
    assert (cell.config["n_trees"], cell.config["max_nodes"]) == (64, 4095)
    assert {m["name"] for m in cell.end_to_end} == {"learn_rows_per_s", "setup_s"}
    res = run_small(T64_CELL, root=grown)
    assert res["correct"], res["checks"]


def _undeclared_lam(root):
    f = root / "perfbench" / "configs" / f"{T64}.json"
    cfg = json.loads(f.read_text())
    f.write_text(json.dumps(dict(cfg, lam=4)))
    return "lam = 4 under from_source"


def _no_limits(root):
    (root / "perfbench" / "limits" / f"{T64_CELL}.json").unlink()
    return "limits file"


def _off_the_rate(root):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    next(m for m in spec["end_to_end"]
         if m["name"] == "learn_rows_per_s")["workloads"].remove(T64_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return "setup_s and one more are due"


@pytest.mark.parametrize("fault", [_undeclared_lam, _no_limits, _off_the_rate])
def test_a_faulty_addition_breaks_a_rule(grown, fault):
    want = fault(grown)
    problems = rules.check(grown)
    assert any(want in p and T64 in p for p in problems), problems


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
                                  serve=SERVE[0])
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


@pytest.mark.parametrize("workload", [LEARN[1], SERVE[0]])
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
