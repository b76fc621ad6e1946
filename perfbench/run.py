"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the system under
test is ``src/repro_torch``.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled window by ``perfbench/metrics/<metric>.py``.  Either way
the run judges what the timed path produced against the plain reference
(``perfbench/reference``) and prints each number compared beside its
limit (``perfbench/limits/<workload>.json``), last on standard error and
last in the result.  The result is the last line of standard output.

Exit codes: 0 a result was printed; 2 bad arguments or benchmark files;
3 no CUDA device, or fewer than the cell asks for; 4 JAX, the JAX
package or the CPU benchmarks were loaded; 5 the program is missing.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """The wall-clock time this process started (Linux /proc), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def limits_of(workload):
    return json.loads((ROOT / "perfbench" / "limits" / f"{workload}.json").read_text())


def verdict(readings, limits):
    """(correct, failed items, {name: {value, limit}}): each number's
    worst reading over the judged items that read it, against its limit.
    A number that no item read fails."""
    worst = {k: None for k in limits}
    failed = 0
    for r in readings:
        bad = False
        for k, lim in limits.items():
            if k in r:
                worst[k] = r[k] if worst[k] is None else max(worst[k], r[k])
                bad |= not r[k] <= lim
        failed += bad
    missing = [k for k, v in worst.items() if v is None]
    checks = {k: {"value": float("nan") if worst[k] is None else worst[k],
                  "limit": limits[k]} for k in limits}
    return bool(readings) and failed == 0 and not missing, failed, checks


def card_info():
    """(name, power limit) of card 0 as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return out or "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None):
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from harness import spec
    try:
        cell = spec.load(args.workload, ROOT)
        limits = limits_of(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"visible", file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is missing ({e})", file=sys.stderr)
        return 5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {}
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_proc, limits, info)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: loaded {found}: the benchmark may load none of "
              f"{FORBIDDEN}", file=sys.stderr)
        return 4
    card = card_info()
    print(f"perfbench: {args.workload} seed {args.seed} on {card}", file=sys.stderr)
    print(f"perfbench: judged {json.dumps(info)}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def judged(out):
    """What the comparison covered: items judged, swap and split steps
    among them, and how far the carried comparison reproduced the
    window."""
    rs = out["readings"]
    info = dict(out.get("carried", {}))
    info.update(items=len(rs), swap_steps=sum(1 for r in rs if r.get("swaps")),
                split_steps=sum(1 for r in rs if r.get("splits")),
                window_swap_steps=sum(1 for r in rs
                                      if r.get("step") == "window" and r.get("swaps")))
    return info


def run_cell(cell, seed, seconds, traced, device, t_proc, limits, info=None):
    """Run the cell on ``device`` and build the result's dict; ``info``,
    a dict, gets what the comparison covered (:func:`judged`)."""
    import torch
    from harness import learn, serve, spec
    kind = cell.traffic["kind"]
    runner = {"learn": learn.run, "serve": serve.run}[kind]
    out = runner(cell, seed, seconds, traced, device, t_proc)
    correct, failed, checks = verdict(out["readings"], limits)
    if info is not None:
        info.update(judged(out))
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    else:
        tr = out["trace"]
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
        for m in cell.per_layer:
            v = spec.reader(m["name"], spec.ROOT)(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
