"""Fault-tolerant LM training loop (the reference's ``train/loop.py``),
on one device or over a ``DeviceMesh``.

* auto-resume from the latest checkpoint (atomic LATEST pointer), with
  restore templates from :func:`repro_torch.train.steps.abstract_state`;
* periodic asynchronous checkpoints in the reference's layout
  (``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``), so each
  package resumes what the other wrote;
* preemption: SIGTERM/SIGINT lead to a final blocking save;
* deterministic skip-ahead (the stream is indexed by step);
* the NaN-step skip inside the step (see steps.py);
* straggler and loss-spike flags from the QO step-time and loss tables:
  the paper's observer watching the trainer itself;
* the publish boundary hands a :class:`Publication`: a read-only handle
  on the live parameters that raises once a later step has written them
  (the reference donates its parameters, so a held publication raises
  there too: "Array has been deleted").

Under a mesh (``Trainer(..., mesh=)``) the step is the sharded one of
:func:`repro_torch.train.steps.build_train_step`, checkpoints restore
into DTensor templates placed by the sharding specs, and rank 0 writes
the files (every rank gathers the leaves it saves).
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
from repro_torch.train import sharding as SH
from repro_torch.train import steps as ST

__all__ = ["LoopConfig", "Trainer", "Publication", "PublicationOverwritten"]


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


class PublicationOverwritten(RuntimeError):
    """A held :class:`Publication` was read after a later train step
    wrote its parameters in place (ROADMAP C16)."""


class Publication:
    """The parameters published at ``step``: a read-only handle on the
    trainer's live parameters, valid until the next train step writes
    them in place.  Each read (:meth:`tree`, :meth:`copy`) first
    compares every leaf's version counter with
    its value at publish time and raises :class:`PublicationOverwritten`,
    naming the step that overwrote them, once one has moved: a held
    publication never silently reads later weights.  A consumer that
    keeps the weights copies them inside ``publish_fn``."""

    def __init__(self, step: int, params):
        self.step = step
        self._params = params
        self._versions = [self._version(t) for _, t in
                          T.tree_leaves(T.tree_of(params))]

    @staticmethod
    def _version(t):
        from repro_torch.train.sharding import local_shard
        return local_shard(t)._version

    def _check(self):
        now = [self._version(t) for _, t in
               T.tree_leaves(T.tree_of(self._params))]
        if now != self._versions:
            raise PublicationOverwritten(
                f"ROADMAP C16: the parameters published at step {self.step} "
                f"were overwritten in place by train step {self.step + 1}; "
                f"copy them inside publish_fn to keep them")

    def tree(self):
        """The live parameter dict (valid until the next step)."""
        self._check()
        return T.tree_of(self._params)

    def copy(self):
        """A detached copy of the parameters (an :class:`LM`, DTensors
        kept placed) that later steps do not touch."""
        self._check()
        tree = T.tree_map(lambda t: t.detach().clone(),
                          T.tree_of(self._params))
        return T.LM(self._params.cfg, tree) if isinstance(
            self._params, T.LM) else tree


class Trainer:
    def __init__(self, cfg, shape, data, loop_cfg: LoopConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None, *, device=None,
                 mesh=None):
        self.cfg, self.shape = cfg, shape
        self.dev = dv.resolve(device)
        self.mesh = mesh
        self.data = data
        self.lc = loop_cfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=loop_cfg.total_steps)
        writer = True
        if mesh is not None:
            import torch.distributed as dist
            writer = dist.get_rank() == 0
        self.ckpt = Checkpointer(loop_cfg.ckpt_dir, write=writer)
        self._preempted = False
        self.step_fn = ST.build_train_step(
            cfg, shape, self.opt_cfg, microbatch=loop_cfg.microbatch,
            remat=loop_cfg.remat, kv_chunk=loop_cfg.kv_chunk,
            device=self.dev, mesh=mesh)
        self.pshapes, self.oshapes = ST.abstract_state(cfg, self.opt_cfg)
        if mesh is not None:   # restore templates: meta DTensors
            pspecs = SH.param_specs(cfg, self.pshapes, mesh)
            self.pshapes = SH.distribute(self.pshapes, pspecs, mesh)
            self.oshapes = SH.distribute(self.oshapes, SH.opt_specs(pspecs),
                                         mesh)

    # -- state ------------------------------------------------------------

    def init_or_restore(self):
        """(params, opt, monitor, start step): the latest checkpoint if
        there is one, else fresh parameters from ``seed``."""
        start = self.ckpt.latest_step()
        mon = MON.init_monitor(device=self.dev)
        if start is not None:
            placed = self.ckpt.restore(
                start, {"params": self.pshapes, "opt": self.oshapes})
            if self.mesh is None:
                placed = reshard(placed, T.tree_map(lambda _: self.dev,
                                                    placed))
            return (T.LM(self.cfg, placed["params"]), placed["opt"], mon,
                    start)
        params = M.init_params(self.cfg, seed=self.lc.seed, device=self.dev,
                               mesh=self.mesh)
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
            publish_fn(step, Publication(step, params))

    def run(self, log_fn: Callable[[Dict[str, Any]], None] = print,
            publish_fn: Optional[Callable[[int, Any], None]] = None):
        """Train to ``total_steps``; returns (params, opt, monitor,
        history).  ``publish_fn(step, publication)`` is the LM loop's
        publish boundary, fired right after every checkpoint save
        (periodic, preemption and final); its exceptions are not caught
        here.  The :class:`Publication` is a read-only handle on the
        parameters the trainer goes on updating in place: reading it
        after the next step raises.  A consumer that wants to keep the
        weights copies them inside ``publish_fn``
        (``publication.copy()``)."""
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
