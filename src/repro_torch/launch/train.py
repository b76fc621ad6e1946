"""CLI training launcher (the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-8b --reduced --steps 200 --batch 8 --seq 256 [--device cpu]

Runs on the card unless ``--device`` names another device.  Compute is
bf16 on ``cuda`` and float32 elsewhere (the reference's ``--f32`` rule,
with the card in the TPU's place).  Auto-resumes from ``--ckpt-dir``;
SIGTERM triggers a final save.

``--mesh local --data-par D --model-par M`` trains over a D x M
("data", "model") ``DeviceMesh`` of the default process group's ranks
(clamped to them; one process a rank, e.g. under ``torchrun``, with gloo
for ``--device cpu``); ``--mesh pod`` / ``multipod`` takes the 16x16 /
2x16x16 production mesh (256 / 512 ranks).  A local 1 x 1 mesh is the
one-device step.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch import device as dv
from repro_torch.configs import ShapeConfig, reduced
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train.loop import LoopConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "pod", "multipod"])
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--f32", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    mesh = None
    if args.mesh == "local":
        if args.data_par * args.model_par > 1:
            mesh = make_local_mesh(args.data_par, args.model_par,
                                   device=args.device)
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"),
                                    device=args.device)
    dev = dv.resolve(args.device)   # after the mesh: its rank's card

    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg, d_model=args.d_model, n_layers=args.layers,
                      n_heads=max(4, args.d_model // 32),
                      n_kv_heads=max(4, args.d_model // 32)
                      if cfg.n_kv_heads else 0,
                      d_ff=args.d_model * 4, head_dim=32)
    if args.f32 and dev.type != "cuda":
        L.set_compute_dtype(torch.float32)

    shape = ShapeConfig("cli_train", args.seq, args.batch, "train")
    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, device=str(dev))
    lc = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, microbatch=args.microbatch)
    opt = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(10, args.steps // 20))
    trainer = Trainer(cfg, shape, data, lc, opt, device=dev, mesh=mesh)
    _, _, mon, _ = trainer.run(
        log_fn=lambda rec: print(json.dumps(rec), flush=True))
    print(json.dumps({"monitor": {
        k: {kk: float(vv) for kk, vv in s.items()}
        for k, s in MON.summaries(mon).items()}}, indent=1))


if __name__ == "__main__":
    main()
