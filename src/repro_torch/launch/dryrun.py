"""Multi-pod dry-run: run the real step of every (arch x shape x mesh)
cell once on meta tensors and count one rank's work (the reference's
``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi3-mini-3.8b --shape decode_32k [--multi-pod] [--out F]

The reference lowers and compiles each cell for 512 forced host devices.
Here a fake process group of 512 ranks (``torch.distributed``'s "fake"
backend: collectives return at once and move nothing) stands in for the
cluster, and this process is rank 0 of the production mesh (16x16
("data", "model"), or 2x16x16 ("pod", "data", "model")).  The cell's
parameters, optimizer state, batch and cache are meta tensors placed by
:mod:`repro_torch.train.sharding`, so nothing is allocated; the train,
prefill or decode step runs once through DTensor, and
:func:`repro_torch.launch.hlocost.analyze` counts rank 0's flops, bytes
and collectives.  ``status`` is "ok" when the step runs and "FAILED"
with the traceback when it does not.

The roofline terms use NVIDIA's H100 SXM data sheet
(:mod:`repro_torch.perf.profile`): 989e12 dense bf16 FLOP/s, 3.35e12 B/s
of HBM and 450e9 B/s of NVLink 4 a direction.  A 16-wide model axis
spans two 8-GPU nodes, whose link is slower than NVLink, so the
collective term is a lower bound.  ``memory_analysis`` gives the rank's
argument bytes (its shards of the parameters, optimizer state, batch,
cache and monitor); temp bytes are None, since meta tensors have no
allocator.  ``compile_s`` is the seconds to build and run the meta step.

The fake group must be this process's first and only group: call
:func:`fake_group` (``run_cell`` does) before anything else starts one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, get_arch, get_shape
from repro_torch.launch import hlocost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.perf.profile import (BF16_FLOPS, HBM_BYTES_PER_S,
                                      NVLINK_BYTES_PER_S)

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLLECTIVE_CAVEAT",
           "model_flops", "should_skip", "fake_group", "run_cell", "main"]

PEAK_FLOPS = BF16_FLOPS        # H100 SXM data sheet, dense bf16
HBM_BW = HBM_BYTES_PER_S       # H100 SXM data sheet
LINK_BW = NVLINK_BYTES_PER_S   # H100 SXM data sheet, NVLink 4 a direction
WORLD = 512
COLLECTIVE_CAVEAT = ("t_collective_s is a lower bound: it prices every "
                     "collective byte at NVLink 4's 450e9 B/s, but a "
                     "16-wide model axis spans two 8-GPU nodes")


def model_flops(cfg, shape):
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N·B a decode
    step (N = active params)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch  # one decode step


def should_skip(cfg, shape) -> str:
    """A reason string if this cell is a designed skip, else ''."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full attention at 524k ctx (quadratic) — designed skip "
                "per assignment")
    return ""


def fake_group(world: int = WORLD) -> None:
    """Start the fake ``world``-rank process group as rank 0, unless it is
    already this process's group; any other group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(
            "the dry-run's fake process group must be this process's first "
            "group: another group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _bytes(tree) -> int:
    from repro_torch.train.sharding import local_shard
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        t = local_shard(tree)
        return t.numel() * t.element_size()
    return 0


def _build(cfg, shape, mesh, kv_chunk, microbatch, remat, **over):
    """(fn, argument bytes, output bytes) of the cell's step on meta
    tensors placed on ``mesh``."""
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import monitor as MON
    from repro_torch.train import sharding as SH
    from repro_torch.train import steps as ST

    meta = torch.device("meta")
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        style = over.get("sharding_style", "contraction")
        step = ST.build_train_step(
            cfg, shape, microbatch=microbatch, remat=remat,
            kv_chunk=kv_chunk, with_monitor=True, device=meta, mesh=mesh,
            donate=False, **over)
        params = M.init_params(cfg, device=meta, mesh=mesh, style=style)
        opt = SH.distribute(adamw.init_state(params), SH.opt_specs(
            SH.param_specs(cfg, params.tree(), mesh, style)), mesh)
        bfield = SH.batch_specs(cfg, shape.kind, B, mesh)
        batch = {k: SH.distribute(v, bfield(k), mesh)
                 for k, v in ST.input_specs(cfg, shape).items()}
        mon = MON.init_monitor(device=meta)
        args = _bytes(params.tree()) + _bytes(opt) + _bytes(batch) \
            + _bytes(mon)
        out = _bytes(params.tree()) + _bytes(opt) + _bytes(mon)
        return (lambda: step(params, opt, batch, mon)), args, out
    prefill, decode, init_cache = ST.build_serve_steps(
        cfg, shape, kv_chunk=kv_chunk, device=meta, mesh=mesh)
    params = M.init_params(cfg, device=meta, mesh=mesh)
    cache = init_cache()
    logits = B * cfg.vocab * 4
    if shape.kind == "prefill":
        pshape = type(shape)(shape.name, S, B, "prefill")
        bfield = SH.batch_specs(cfg, "prefill", B, mesh)
        batch = {k: SH.distribute(v, bfield(k), mesh)
                 for k, v in ST.input_specs(cfg, pshape).items()}
        args = _bytes(params.tree()) + _bytes(batch) + _bytes(cache)
        return (lambda: prefill(params, batch, cache)), args, \
            _bytes(cache) + logits
    token = torch.zeros((B,), dtype=torch.int32, device=meta)
    args = _bytes(params.tree()) + _bytes(cache) + token.numel() * 4
    return (lambda: decode(params, token, cache, S - 1)), args, \
        _bytes(cache) + logits


def _terms(cfg, shape, walked, chips):
    flops, bytes_ = walked["flops"], walked["bytes"]
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = walked["collective_bytes"] / LINK_BW
    mf = model_flops(cfg, shape)
    t_max = max(t_compute, t_memory, t_coll)
    return {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": max([("compute", t_compute), ("memory", t_memory),
                           ("collective", t_coll)],
                          key=lambda kv: kv[1])[0],
        "model_flops_total": mf,
        "useful_flops_ratio": (mf / chips) / flops if flops else 0.0,
        "roofline_fraction": (mf / chips / PEAK_FLOPS) / t_max
        if t_max > 0 else 0.0,
        "collective_caveat": COLLECTIVE_CAVEAT,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, kv_chunk=512,
             microbatch=0, remat=True):
    """One cell's result dict (the reference's keys)."""
    cfg = get_arch(arch)
    shape = get_shape(shape_name)
    skip = should_skip(cfg, shape)
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16"}
    if skip:
        result["status"] = "skipped"
        result["reason"] = skip
        return result

    fake_group()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    chips = mesh.size()
    t0 = time.time()
    try:
        fn, arg_bytes, out_bytes = _build(cfg, shape, mesh, kv_chunk,
                                          microbatch, remat)
        walked = hlocost.analyze(fn)
    except Exception as e:  # a failure here is a fault in the sharding
        result["status"] = "FAILED"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        return result

    result.update({
        "status": "ok",
        "compile_s": round(time.time() - t0, 1),
        "chips": chips,
        "hlo_flops_per_chip": walked["flops"],
        "hlo_bytes_per_chip": walked["bytes"],
        "collective_bytes_per_chip": walked["collective_bytes"],
        "collective_breakdown": walked["collectives"],
        **_terms(cfg, shape, walked, chips),
        # eager PyTorch has no compiler cost analysis to compare with
        "raw_cost_analysis_flops": None,
        "memory_analysis": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": None,
            "generated_code_size_bytes": None,
        },
    })
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--kv-chunk", type=int, default=512)
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)
    fake_group()

    archs = sorted(configs.ARCHS) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if key in done:
                    continue
                print(f"=== {arch} x {shape} x {key[2]} ===", flush=True)
                r = run_cell(arch, shape, mp, kv_chunk=args.kv_chunk)
                print(json.dumps({k: v for k, v in r.items()
                                  if k not in ("traceback",
                                               "collective_breakdown",
                                               "memory_analysis")}),
                      flush=True)
                results.append(r)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_fail = sum(1 for r in results if r["status"] == "FAILED")
    print(f"\n{len(results)} cells, {n_fail} failures")
    print(COLLECTIVE_CAVEAT)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
