"""The readings that the limits of ``perfbench/limits/<workload>.json``
are set from, for one cell, on several seeds in one process.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 --seconds 5

For each seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the judged steps or requests) and prints, as one JSON line,
the program's worst reading of each number compared (the lower reading)
and the control's (the upper reading): the plain reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place on the same judged window steps or requests and on
sixteen evenly spaced steps of the carried comparison.  The last line
sums up: the largest program reading and the smallest control reading of
each number over the seeds.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worst(readings, names):
    """Each number's largest reading over the items that read it."""
    return {k: max((float(r[k]) for r in readings if k in r), default=0.0) for k in names}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]
    import torch
    from harness import learn, serve, spec
    import run as bench
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load(args.workload, ROOT)
    names = list(bench.limits_of(args.workload))
    runner = {"learn": learn.run, "serve": serve.run}[cell.traffic["kind"]]
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        control = []
        out = runner(cell, seed, args.seconds, False, "cuda", time.time(), control)
        prog, ctl = worst(out["readings"], names), worst(control, names)
        extra = {k: max(r.get(k, 0) for r in out["readings"])
                 for k in ("adopted", "splits", "swaps")}
        print(json.dumps({"seed": seed, "program": prog, "control": ctl,
                          "judged": len(out["readings"]), **extra,
                          "state_err_at": sorted({r.get("state_err_at", "")
                                                  for r in out["readings"]})}), flush=True)
        for k in names:
            lower[k] = max(lower.get(k, 0.0), prog[k])
            upper[k] = min(upper.get(k, float("inf")), ctl[k])
        del out, control
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "card": bench.card_info(),
                      "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
