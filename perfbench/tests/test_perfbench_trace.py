"""The trace reader: window, busy union, counts and breakdown; and, on a
card, one traced run of each cell."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _events():
    X = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return [
        X("perfbench.window", "user_annotation", 1000, 100),
        X("void qo_route_kernel<256>(int)", "kernel", 1010, 10),
        X("qo_update_leaves_pieces_kernel", "kernel", 1015, 10),    # overlaps
        X("Memcpy DtoH", "gpu_memcpy", 1050, 5),
        X("qo_route_kernel", "kernel", 2000, 5),                   # after the window
        X("aten::nonzero", "cpu_op", 1025, 25),
        X("cudaStreamSynchronize", "cuda_runtime", 1030, 20),
        X("cudaLaunchKernel", "cuda_runtime", 1005, 2),
        {"ph": "s", "name": "flow", "cat": "ac2g", "ts": 1005},
    ]


def test_parse_window_busy_and_counts():
    from harness import trace
    tr = trace.parse(_events())
    assert tr.window_us == 100
    assert tr.busy_intervals() == [[10.0, 25.0], [50.0, 55.0]]
    assert tr.busy_us == 20
    assert tr.count_device(("kernel",)) == 2
    assert tr.count_device(("kernel", "gpu_memcpy", "gpu_memset")) == 3
    assert tr.count_host(trace.SYNC_CALLS) == 1
    assert tr.kernel_us(("qo_route",)) == 10
    assert tr.kernel_us(("qo_update_leaves",)) == 10


def test_breakdown_names_gaps_by_the_innermost_host_event():
    from harness import trace
    b = trace.parse(_events()).breakdown()
    assert b["device_ops"][0][1] == pytest.approx(10e-6)
    gaps = dict(b["idle_gaps"])
    # 25..50 lies in aten::nonzero; its midpoint in cudaStreamSynchronize
    assert gaps["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert sum(gaps.values()) == pytest.approx(80e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_parse_needs_the_window():
    from harness import trace
    with pytest.raises(RuntimeError):
        trace.parse(_events()[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_traced_run_on_the_card(cuda_device, workload):
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                          workload, "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0 and res["metrics"]
