"""The gloo ranks of ``tests/test_torch_lm_sharding.py``: spawned
processes import this module (torch and the port only, no JAX), so a
rank starts in a few seconds.  Each rank writes its results to
``rank<r>.pt`` in the run's directory."""
import datetime
import logging
import os

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.configs import ShapeConfig
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import sharding as SH
from repro_torch.train import steps as ST

# the reference's tests/test_sharding.py model
LOSS_KW = dict(d_model=64, n_heads=8, n_kv_heads=4, vocab=256, head_dim=16)
LOSS_SHAPE = ShapeConfig("t", 64, 8, "train")
PLACED_ARCHS = ("qwen3-8b", "grok-1-314b", "falcon-mamba-7b", "zamba2-2.7b",
                "whisper-medium")
STYLES = ("contraction", "gather")
VARIANTS = {"contraction": {}, "seq_parallel": {"seq_parallel": True},
            "gather": {"sharding_style": "gather"}}
SERVE_B, SERVE_S, SERVE_PROMPT, SERVE_DECODE = 4, 32, 24, 4
SERVE_KV = {"heads": 4, "seq": 1}        # KV heads: over TP / not dividing
TRAINER_STEPS = 4


JOIN_SECONDS = 240


def spawn_ranks(fn, world, tmp, inputs):
    """Run ``fn(rank, world, tmp, inputs)`` on ``world`` spawned ranks
    (killed past JOIN_SECONDS); returns each rank's ``rank<r>.pt``."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(fn, args=(world, tmp, inputs), nprocs=world, join=False)
    deadline = JOIN_SECONDS
    try:
        while not ctx.join(timeout=5):
            deadline -= 5
            if deadline <= 0:
                raise AssertionError(f"gloo ranks did not finish within "
                                     f"{JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class HostBatches:
    """Batches given as numpy arrays, as the port's Trainer reads them."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, step):
        return {k: torch.tensor(v) for k, v in self.batches[step].items()}


def quiet():
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    TL.set_compute_dtype(torch.float32)


def init_gloo(rank, world, tmp):
    import torch.distributed as dist
    quiet()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))


def placed_cfg(arch):
    return TC.reduced(TC.get_arch(arch))


def loss_cfg():
    return TC.reduced(TC.get_arch("qwen3-8b"), **LOSS_KW)


def local_shards(tree):
    return {"/".join(p): SH.local_shard(t).detach().numpy().copy()
            for p, t in TT.tree_leaves(tree)}


def train_rank(rank, world, tmp, inputs):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    init_gloo(rank, world, tmp)
    try:
        mesh = make_local_mesh(4, 2, device="cpu")
        out = {"coord": tuple(mesh.get_coordinate()), "shards": {},
               "loss": {}}
        for arch in PLACED_ARCHS:
            t = placed_cfg(arch)
            whole = convert.lm_params_from_numpy(
                t, inputs["placed"][arch], device="cpu").tree()
            for style in STYLES:
                placed = SH.distribute(whole, SH.param_specs(
                    t, whole, mesh, style), mesh)
                out["shards"][arch, style] = local_shards(placed)
        t = loss_cfg()
        batch = {k: torch.as_tensor(v) for k, v in inputs["batch"].items()}
        for name, kw in VARIANTS.items():
            step = ST.build_train_step(t, LOSS_SHAPE, device="cpu",
                                       mesh=mesh, donate=False, **kw)
            lm = convert.lm_params_from_numpy(t, inputs["loss_params"],
                                              device="cpu")
            params = TT.LM(t, SH.distribute(lm.tree(), SH.param_specs(
                t, lm.tree(), mesh, kw.get("sharding_style",
                                           "contraction")), mesh))
            opt = adamw.init_state(params)
            before = (local_shards(params.tree()), local_shards(opt))
            mon = MON.init_monitor(device="cpu")
            _, _, m, new_mon = step(params, opt, batch, mon)
            out["loss"][name] = (float(m["loss"]), float(m["grad_norm"]))
            if name == "contraction":
                out["unchanged"] = all(
                    np.array_equal(a, b) for was, now in zip(
                        before, (local_shards(params.tree()), local_shards(opt)))
                    for a, b in zip(was.values(), now.values()))
                out["unchanged"] &= float(MON.summaries(mon)["loss"][
                    "count"]) == 0 and float(MON.summaries(new_mon)[
                        "loss"]["count"]) == 1
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def serve_cfg(kv):
    return TC.reduced(TC.get_arch("qwen3-8b"), n_kv_heads=kv)


def serve(cfg, params, prompt, mesh):
    shape = ShapeConfig("s", SERVE_S, SERVE_B, "decode")
    prefill, decode, init_cache = ST.build_serve_steps(
        cfg, shape, device="cpu", mesh=mesh)
    cache, logits = prefill(params, {"tokens": prompt}, init_cache())
    out = [logits]
    for i in range(SERVE_DECODE):
        tok = out[-1].argmax(-1).to(torch.int32)
        logits, cache = decode(params, tok, cache, SERVE_PROMPT + i)
        out.append(logits)
    k = cache["attn"]["k"]
    return torch.stack(out).numpy(), [
        (type(p).__name__, getattr(p, "dim", None))
        for p in getattr(k, "placements", ())]


def serve_rank(rank, world, tmp, inputs):
    import torch.distributed as dist
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import LoopConfig, Trainer
    init_gloo(rank, world, tmp)
    try:
        mesh = make_local_mesh(2, 2, device="cpu")
        out = {"serve": {}}
        prompt = torch.as_tensor(inputs["prompt"])
        for name, kv in SERVE_KV.items():
            cfg = serve_cfg(kv)
            params = TM.init_params(cfg, seed=0, device="cpu", mesh=mesh)
            out["serve"][name] = serve(cfg, params, prompt, mesh)
        # a sharded Trainer resumes the reference's step-0 checkpoint and
        # writes its own at step 4
        t = loss_cfg()
        data = HostBatches(inputs["batches"])
        tr = Trainer(t, LOSS_SHAPE, data, LoopConfig(
            total_steps=TRAINER_STEPS, ckpt_every=4, log_every=4, kv_chunk=32,
            ckpt_dir=inputs["ckpt_dir"]), adamw.AdamWConfig(
                lr=5e-3, total_steps=8, warmup_steps=4), device="cpu",
            mesh=mesh)
        params, _, _, hist = tr.run(log_fn=lambda rec: None)
        out["trainer"] = {"start": hist[0]["step"],
                          "params": {"/".join(p): SH.local(t_).detach().numpy()
                                     for p, t_ in TT.tree_leaves(
                                         params.tree())}}
        dist.barrier()
        tlaunch.main(["--reduced", "--device", "cpu", "--data-par", "2",
                      "--model-par", "2", "--steps", "2", "--ckpt-every",
                      "2", "--d-model", "64", "--layers", "1", "--batch",
                      "4", "--seq", "32", "--ckpt-dir",
                      os.path.join(tmp, "launch")])
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def all_gather_rank(rank, world, tmp, inputs):
    """A row-sharded (8, 16) float32 DTensor gathered whole under the
    op-count walker."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import hlocost
    from repro_torch.launch.mesh import make_mesh_auto
    init_gloo(rank, world, tmp)
    try:
        mesh = make_mesh_auto((world,), ("data",), device="cpu")
        rows = 8 // world
        x = DTensor.from_local(torch.full((rows, 16), float(rank)), mesh,
                               [Shard(0)])
        out = {}
        walked = hlocost.analyze(lambda: out.setdefault(
            "whole", x.redistribute(mesh, [Replicate()]).to_local()))
        torch.save({"walked": walked, "whole": out["whole"]},
                   os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
