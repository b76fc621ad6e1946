"""Fault-tolerant LM training loop (the reference's ``train/loop.py``)
on one device.

* auto-resume from the latest checkpoint (atomic LATEST pointer), with
  restore templates from :func:`repro_torch.train.steps.abstract_state`;
* periodic asynchronous checkpoints in the reference's layout
  (``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``), so each
  package resumes what the other wrote;
* preemption: SIGTERM/SIGINT lead to a final blocking save;
* deterministic skip-ahead (the stream is indexed by step);
* the NaN-step skip inside the step (see steps.py);
* straggler and loss-spike flags from the QO step-time and loss tables:
  the paper's observer watching the trainer itself.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch import device as dv
from repro_torch.checkpoint.ckpt import Checkpointer, reshard
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import steps as ST

__all__ = ["LoopConfig", "Trainer"]


@dataclass
class LoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    microbatch: int = 0
    remat: bool = True
    kv_chunk: int = 512
    seed: int = 0


class Trainer:
    def __init__(self, cfg, shape, data, loop_cfg: LoopConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None, *, device=None,
                 mesh=None):
        ST._refuse_sharding(mesh)
        self.cfg, self.shape = cfg, shape
        self.dev = dv.resolve(device)
        self.data = data
        self.lc = loop_cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=loop_cfg.total_steps)
        self.ckpt = Checkpointer(loop_cfg.ckpt_dir)
        self._preempted = False
        self.step_fn = ST.build_train_step(
            cfg, shape, self.opt_cfg, microbatch=loop_cfg.microbatch,
            remat=loop_cfg.remat, kv_chunk=loop_cfg.kv_chunk,
            device=self.dev)
        self.pshapes, self.oshapes = ST.abstract_state(cfg, self.opt_cfg)

    # -- state ------------------------------------------------------------

    def init_or_restore(self):
        """(params, opt, monitor, start step): the latest checkpoint if
        there is one, else fresh parameters from ``seed``."""
        start = self.ckpt.latest_step()
        mon = MON.init_monitor(device=self.dev)
        if start is not None:
            host = self.ckpt.restore(
                start, {"params": self.pshapes, "opt": self.oshapes})
            devs = T.tree_map(lambda _: self.dev, host)
            placed = reshard(host, devs)
            return (T.LM(self.cfg, placed["params"]), placed["opt"], mon,
                    start)
        params = M.init_params(self.cfg, seed=self.lc.seed, device=self.dev)
        return params, adamw.init_state(params), mon, 0

    # -- preemption -------------------------------------------------------

    def _install_signals(self):
        """Flag a preemption on SIGTERM/SIGINT; returns the handlers to put
        back (none off the main thread)."""
        def handler(sig, frame):
            self._preempted = True
        old = {}
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                old[s] = signal.signal(s, handler)
            except ValueError:
                pass  # not on the main thread
        return old

    # -- run --------------------------------------------------------------

    def _save(self, step, params, opt, publish_fn, blocking=False):
        self.ckpt.save(step, {"params": params.tree(), "opt": opt},
                       blocking=blocking)
        if publish_fn is not None:
            publish_fn(step, params)

    def run(self, log_fn: Callable[[Dict[str, Any]], None] = print,
            publish_fn: Optional[Callable[[int, Any], None]] = None):
        """Train to ``total_steps``; returns (params, opt, monitor,
        history).  ``publish_fn(step, params)`` is the LM loop's publish
        boundary, fired right after every checkpoint save (periodic,
        preemption and final); its exceptions are not caught here."""
        old = self._install_signals()
        try:
            return self._run(log_fn, publish_fn)
        finally:
            self.ckpt.wait()
            for s, h in old.items():
                signal.signal(s, h)

    def _run(self, log_fn, publish_fn):
        params, opt, mon, start = self.init_or_restore()
        history = []
        for step in range(start, self.lc.total_steps):
            batch = self.data.batch(step)  # deterministic skip-ahead
            t0 = time.perf_counter()
            params, opt, metrics, mon = self.step_fn(params, opt, batch, mon)
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0
            mon = MON.observe(mon, step_time=dt)

            if step % self.lc.log_every == 0 or \
                    step == self.lc.total_steps - 1:
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]),
                       "skipped": float(metrics["skipped"]),
                       "sec_per_step": dt,
                       "straggler": bool(MON.is_straggler(mon, dt)),
                       "loss_spike": bool(MON.loss_spike(mon, loss))}
                history.append(rec)
                log_fn(rec)

            if (step + 1) % self.lc.ckpt_every == 0:
                self._save(step + 1, params, opt, publish_fn)

            if self._preempted:
                log_fn({"step": step, "event": "preempted — final save"})
                self._save(step + 1, params, opt, publish_fn, blocking=True)
                return params, opt, mon, history
        self._save(self.lc.total_steps, params, opt, publish_fn,
                   blocking=True)
        return params, opt, mon, history
