"""Perf variants of a dry-run cell: run each named set of build overrides
once on the fake production mesh and report the roofline terms (the
reference's ``launch/perf.py``).

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell qwen3-8b:train_4k --variant baseline,seq_parallel

Each variant is a named set of build overrides and module switches
(``moe_bf16``: :func:`repro_torch.models.layers.set_moe_combine_dtype`
bf16; ``lean``: ``set_lean_internals``; ``ssd``:
:func:`repro_torch.models.ssm.set_mamba2_impl` "ssd"); results append to
``--out`` with the cell, the variant and its three terms.  The terms use
the H100 data-sheet constants of :mod:`repro_torch.launch.dryrun`, whose
collective term is a lower bound.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.launch import dryrun, hlocost
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["VARIANTS", "run_variant", "main"]

VARIANTS = {
    "baseline": {},
    "seq_parallel": {"seq_parallel": True},
    "microbatch8": {"microbatch": 8},
    "microbatch16": {"microbatch": 16},
    "no_remat": {"remat": False},
    "no_remat_mb8": {"remat": False, "microbatch": 8},
    "seqpar_mb8": {"seq_parallel": True, "microbatch": 8},
    "seqpar_mb16": {"seq_parallel": True, "microbatch": 16},
    "kv2048": {"kv_chunk": 2048},
    "kv128": {"kv_chunk": 128},
    "seqpar_norematmb8": {"seq_parallel": True, "remat": False,
                          "microbatch": 8},
    "moe_bf16_combine": {"moe_bf16": True},
    "moe_bf16_mb16": {"moe_bf16": True, "microbatch": 16},
    "mamba2_ssd": {"ssd": True},
    "mamba2_ssd_mb8": {"ssd": True, "microbatch": 8},
    "weight_gather": {"sharding_style": "gather"},
    "wg_seqpar": {"sharding_style": "gather", "seq_parallel": True},
    "wg_mb16": {"sharding_style": "gather", "microbatch": 16},
    "wg_seqpar_mb8": {"sharding_style": "gather", "seq_parallel": True,
                      "microbatch": 8},
    "wg_ssd": {"sharding_style": "gather", "ssd": True},
    "wg_ssd_mb8": {"sharding_style": "gather", "ssd": True, "microbatch": 8},
    "lean": {"lean": True},
    "lean_mb16": {"lean": True, "microbatch": 16},
    "wg_seqpar_lean": {"sharding_style": "gather", "seq_parallel": True,
                       "lean": True},
    "ssd_mb8_lean": {"ssd": True, "microbatch": 8, "lean": True},
}


def run_variant(arch, shape_name, variant, extra=None, multi_pod=False):
    """One variant's result dict (the reference's keys).  The module
    switches stay set as the variant left them, as in the reference."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    over = dict(VARIANTS[variant])
    over.update(extra or {})
    L.set_moe_combine_dtype(
        torch.bfloat16 if over.pop("moe_bf16", False) else torch.float32)
    L.set_lean_internals(over.pop("lean", False))
    S.set_mamba2_impl("ssd" if over.pop("ssd", False) else "scan")
    build = {k: over.pop(k) for k in ("kv_chunk", "microbatch", "remat")
             if k in over}
    dryrun.fake_group()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    fn, _, _ = dryrun._build(cfg, shape, mesh, build.get("kv_chunk", 512),
                             build.get("microbatch", 0),
                             build.get("remat", True), **over)
    walked = hlocost.analyze(fn)
    chips = mesh.size()
    terms = dryrun._terms(cfg, shape, walked, chips)
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "overrides": dict(over, **build),
        "compile_s": round(time.time() - t0, 1),
        "t_compute_s": terms["t_compute_s"],
        "t_memory_s": terms["t_memory_s"],
        "t_collective_s": terms["t_collective_s"],
        "dominant": terms["bottleneck"],
        "collectives": walked["collectives"],
        "useful_flops_ratio": terms["useful_flops_ratio"],
        "roofline_fraction": terms["roofline_fraction"],
        # meta tensors have no allocator
        "temp_bytes": None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True,
                    help=f"one of {sorted(VARIANTS)} (comma separated ok)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="perf_results.json")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    dryrun.fake_group()

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for variant in args.variant.split(","):
        print(f"=== {arch}:{shape} [{variant}] ===", flush=True)
        r = run_variant(arch, shape, variant, multi_pod=args.multi_pod)
        if args.multi_pod:
            r["variant"] = variant + "@2x16x16"
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("collectives",)}), flush=True)
        results.append(r)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(dryrun.COLLECTIVE_CAVEAT)


if __name__ == "__main__":
    main()
