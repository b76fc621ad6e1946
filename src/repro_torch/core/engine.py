"""Continuous-serving engine: train and serve at once, with snapshot
hot-swap, admission control, rollback and crash recovery (the reference's
``core/engine.py``, DESIGN.md §5.6).

**Admission queue.**  Requests arrive open-loop through
:meth:`ServingEngine.submit`, which hands back a :class:`Ticket` at once.
A request that would push the queue past ``cfg.max_queue_rows`` is SHED
whole at the door (its ticket resolves ``shed``, the ``shed_requests`` /
``shed_rows`` counters advance).  Admitted tickets are packed FIFO into
serving batches of up to ``cfg.max_batch_rows`` rows, served by one
:func:`repro_torch.core.serve.predict_snapshot` a batch.

**Atomic publish.**  The trainer :func:`~repro_torch.core.serve.freeze`\\ s
its live state every ``sync_every`` batches and offers the snapshot to
:meth:`ServingEngine.publish`: the ``publish`` fault site, then
:func:`~repro_torch.core.serve.validate_snapshot` (an invalid snapshot is
counted and discarded: the last good version keeps serving), a
monotone-version check, and only then the swap -- one reference
assignment of an immutable record, so a server thread sees the old
snapshot or the new one, never a mix.

**Fault tolerance.**  A :class:`repro_torch.core.faults.FaultInjector`
hooks ``trainer.step`` / ``publish`` / ``ckpt.save``.  A crashed trainer
step is counted and recovered: the state restores from the newest valid
checkpoint (:meth:`Checkpointer.restore_latest` skips corrupt ones), the
stream rewinds to its step, and the restored model is re-published at
once.  Without a (valid) checkpoint the trainer keeps its state as it was
before the step that crashed: the port's ``update`` writes the QO tables
in place, so the engine keeps a device copy of the state across every
step (:meth:`ServingEngine._train_step`) where the reference keeps its
immutable state.  A staleness watchdog raises ``stale`` (and counts
``stale_events``) when the published snapshot falls
``cfg.staleness_factor * sync_every`` trainer steps behind.

The engine is a deterministic state machine first and threads second:
:meth:`~ServingEngine.train_once` / :meth:`~ServingEngine.serve_once`
single-step the two loops, and :meth:`~ServingEngine.start` /
:meth:`~ServingEngine.stop` run the same methods on daemon threads.  It
runs on ``device`` (default ``cuda``); the state must live there.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as dv
from repro_torch.core import faults as fl
from repro_torch.core import forest as fr
from repro_torch.core import hoeffding as ht
from repro_torch.core import serve as sv

__all__ = ["EngineConfig", "Ticket", "ServingEngine"]


@dataclass(frozen=True)
class EngineConfig:
    """Static engine knobs.

    sync_every:       trainer batches between freeze+publish boundaries.
    ckpt_every:       publishes between checkpoint saves (0 = never).
    max_queue_rows:   admission bound -- rows queued beyond this are shed.
    max_batch_rows:   serving pack cap -- queued tickets are concatenated
                      up to this many rows per dispatch.
    keep_versions:    published snapshots retained for drain/rollback
                      audits (``snapshot_for_version``).
    staleness_factor: ``stale`` when the published snapshot's age exceeds
                      ``staleness_factor * sync_every`` trainer steps.
    backend:          the reference's serving-backend knob; the port takes
                      only ``None`` (the tensors' device selects kernel or
                      plain version).
    """
    sync_every: int = 4
    ckpt_every: int = 1
    max_queue_rows: int = 8192
    max_batch_rows: int = 2048
    keep_versions: int = 4
    staleness_factor: float = 3.0
    backend: Optional[str] = None

    def __post_init__(self):
        if self.backend is not None:
            raise ValueError(
                f"backend={self.backend!r}: the port takes only None (the "
                f"tensors' device selects kernel or plain version)")


class Ticket:
    """One admitted (or shed) request: a thread-safe future.

    ``status``: ``"queued" | "done" | "shed"``.  ``wait(timeout)`` blocks
    until resolution; ``result`` is the (B,) f32 predictions as a numpy
    array, ``version`` the snapshot version that served them
    (``predict_snapshot(engine.snapshot_for_version(t.version), X)``
    equals ``t.result`` bit for bit), ``latency_s`` the submit->resolve
    wall time.
    """

    __slots__ = ("X", "status", "result", "version", "t_submit", "t_done",
                 "_event")

    def __init__(self, X: np.ndarray):
        self.X = X
        self.status = "queued"
        self.result: Optional[np.ndarray] = None
        self.version: Optional[int] = None
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self._event = threading.Event()

    @property
    def rows(self) -> int:
        return self.X.shape[0]

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _resolve(self, status: str, result=None, version=None):
        self.status = status
        self.result = result
        self.version = version
        self.t_done = time.perf_counter()
        self._event.set()


class _Published:
    """Immutable published record -- the single swapped reference.
    Readers grab ``engine._published`` ONCE per serving batch, which pins
    a consistent (snapshot, version, step, wall-clock) tuple."""

    __slots__ = ("snap", "version", "step", "wall")

    def __init__(self, snap: sv.Snapshot, version: int, step: int):
        self.snap = snap
        self.version = version
        self.step = step
        self.wall = time.monotonic()


def _clone(tree):
    """A copy of a state whose tensors share no memory with it."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class ServingEngine:
    """Concurrent train-and-serve over one model lineage.

    ``cfg_model``: a :class:`repro_torch.core.forest.ForestConfig` (its
    ``"trees"``-keyed state) or a
    :class:`repro_torch.core.hoeffding.HTRConfig` (a single tree).
    ``state``: the initial model state, on ``device``.
    ``stream``: ``stream(step) -> (X, y) | None``, a deterministic batch
    source indexed by trainer step (None = exhausted), so a recovered
    trainer replays it exactly.
    ``checkpointer``: optional
    :class:`repro_torch.checkpoint.ckpt.Checkpointer`.
    ``injector``: optional :class:`repro_torch.core.faults.FaultInjector`.
    ``device``: where the state lives and the engine trains and serves
    (default ``cuda``; raises when no GPU is visible).

    The constructor publishes version 1 from the initial state, so the
    engine serves from its very first request.
    """

    def __init__(self, cfg_model, state, stream: Callable, *,
                 cfg: EngineConfig = EngineConfig(),
                 checkpointer=None, injector: Optional[fl.FaultInjector] = None,
                 device=None):
        self._dev = dv.resolve(device)
        leaf = state["vote_w"] if "trees" in state else state["feature"]
        dv.check_on(leaf, self._dev, "state")
        self.cfg = cfg
        self._model_cfg = cfg_model
        self._state = state
        self._stream = stream
        self._ckpt = checkpointer
        self._injector = injector or fl.FaultInjector()

        self._trainer_step = 0
        self._queue: List[Ticket] = []
        self._queued_rows = 0
        self._q_lock = threading.Lock()
        self._q_event = threading.Event()
        self._pub_lock = threading.Lock()
        self._published: Optional[_Published] = None
        self._versions: Dict[int, sv.Snapshot] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._m_lock = threading.Lock()
        self._metrics = {
            "admitted_requests": 0, "admitted_rows": 0,
            "served_requests": 0, "served_rows": 0, "serve_batches": 0,
            "shed_requests": 0, "shed_rows": 0,
            "publishes": 0, "publish_failures": 0, "rollbacks": 0,
            "publishes_dropped": 0, "trainer_crashes": 0, "recoveries": 0,
            "ckpt_failures": 0, "stale_events": 0, "max_queue_rows_seen": 0,
        }
        self.publish_from_state()            # version 1: never cold-start
        if self._published is None:
            raise sv.SnapshotValidationError(
                "the initial state did not publish")

    # -- metrics ----------------------------------------------------------

    def _bump(self, **kv):
        with self._m_lock:
            for k, v in kv.items():
                self._metrics[k] += v

    def metrics(self) -> Dict[str, Any]:
        """Counter snapshot + the staleness watchdog's current verdict."""
        with self._m_lock:
            out = dict(self._metrics)
        out.update(self.staleness())
        return out

    def staleness(self) -> Dict[str, Any]:
        """Snapshot age vs the ``sync_every`` cadence (the watchdog):
        ``age_steps`` = trainer steps since the published snapshot was
        frozen; ``stale`` once it exceeds ``staleness_factor *
        sync_every``."""
        rec = self._published
        age_steps = self._trainer_step - rec.step
        limit = self.cfg.staleness_factor * self.cfg.sync_every
        return {
            "published_version": rec.version,
            "published_step": rec.step,
            "age_steps": age_steps,
            "age_s": time.monotonic() - rec.wall,
            "stale": age_steps > limit,
        }

    # -- publish path -----------------------------------------------------

    @property
    def published_version(self) -> int:
        return self._published.version

    def snapshot_for_version(self, version: int) -> sv.Snapshot:
        """A retained published snapshot by version (the last
        ``cfg.keep_versions`` publishes are retained)."""
        return self._versions[version]

    def publish_from_state(self) -> bool:
        """Freeze the live trainer state and offer it for publication."""
        with self._pub_lock:
            version = (self._published.version + 1) if self._published else 1
        snap = sv.freeze(self._state, version=version,
                         step=self._trainer_step, device=self._dev)
        return self.publish(snap)

    def publish(self, snap: sv.Snapshot) -> bool:
        """Validate -> atomically swap; False = rejected (rollback).

        The candidate passes the ``publish`` fault site, then
        :func:`~repro_torch.core.serve.validate_snapshot` and a
        monotone-version gate.  Any failure leaves the previous snapshot
        serving and advances ``publish_failures`` / ``rollbacks``; success
        swaps one immutable record under ``_pub_lock``, retains the
        version, and checkpoints every ``ckpt_every`` publishes."""
        try:
            snap = self._injector.fire("publish", snap)
        except fl.DropSignal:
            self._bump(publishes_dropped=1)
            return False
        try:
            sv.validate_snapshot(snap)
            with self._pub_lock:
                if (self._published is not None
                        and snap.version <= self._published.version):
                    raise sv.SnapshotValidationError(
                        f"version {snap.version} is not past published "
                        f"v{self._published.version}")
                rec = _Published(snap, snap.version, snap.step)
                self._published = rec          # THE atomic hot-swap
                self._versions[rec.version] = snap
                while len(self._versions) > self.cfg.keep_versions:
                    del self._versions[min(self._versions)]
        except sv.SnapshotValidationError:
            self._bump(publish_failures=1, rollbacks=1)
            return False
        self._bump(publishes=1)
        if self._ckpt is not None and self.cfg.ckpt_every \
                and self._metrics["publishes"] % self.cfg.ckpt_every == 0:
            self._checkpoint()
        return True

    def _checkpoint(self):
        try:
            self._injector.fire("ckpt.save")
            self._ckpt.save(self._trainer_step, self._state, blocking=True)
        except Exception:
            # a failed save must never take the trainer down: the last
            # good checkpoint is still on disk and restore skips torn ones
            self._bump(ckpt_failures=1)

    # -- trainer ----------------------------------------------------------

    def train_once(self) -> bool:
        """One trainer batch (False = stream exhausted).

        Learns ``stream(step)``, advances the step, and at every
        ``sync_every`` boundary freezes + publishes.  Any exception out of
        the step is caught, counted in ``trainer_crashes`` and answered
        with :meth:`recover`; serving goes on from the published
        snapshot throughout."""
        batch = self._stream(self._trainer_step)
        if batch is None:
            return False
        try:
            self._injector.fire("trainer.step")
            self._state = self._train_step(batch)
            self._trainer_step += 1
            if self._trainer_step % self.cfg.sync_every == 0:
                self.publish_from_state()
            elif self.staleness()["stale"]:
                self._bump(stale_events=1)
        except Exception:
            self._bump(trainer_crashes=1)
            self.recover()
        return True

    def _train_step(self, batch):
        """Learn one batch on the engine's device.  The update writes the
        QO tables in place, so a device copy of the state is kept across
        the step and put back if the step raises: the state after a crash
        is the state before the step, as the reference's immutable state
        is."""
        X, y = batch
        before = _clone(self._state)
        try:
            if "trees" in self._state:
                state, _aux = fr.update(self._model_cfg, self._state, X, y,
                                        device=self._dev)
            else:
                state = ht.update(self._model_cfg, self._state, X, y,
                                  device=self._dev)
        except BaseException:
            self._state = before
            raise
        return state

    def recover(self):
        """Crash recovery: restore the newest valid checkpoint (or keep the
        pre-crash state), rewind the stream to its step, and RE-PUBLISH at
        once.  The live state is the restore's template, so the restored
        state lands on the engine's device."""
        if self._ckpt is not None:
            try:
                state, step = self._ckpt.restore_latest(
                    self._state, return_step=True)
                self._state, self._trainer_step = state, step
            except FileNotFoundError:
                pass                      # no valid checkpoint: keep memory
        self._bump(recoveries=1)
        self.publish_from_state()

    # -- admission + serving ----------------------------------------------

    def submit(self, X) -> Ticket:
        """Admit a request (or shed it) -- never blocks on service.

        Admission is all-or-nothing per request: if the queue cannot hold
        the WHOLE request under ``max_queue_rows``, the ticket resolves
        ``shed`` at once and the shed counters advance by this request."""
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            raise ValueError(f"a request is (rows, features), got {X.shape}")
        t = Ticket(X)
        with self._q_lock:
            if self._queued_rows + t.rows > self.cfg.max_queue_rows:
                admitted = False
            else:
                admitted = True
                self._queue.append(t)
                self._queued_rows += t.rows
                depth = self._queued_rows
        if admitted:
            self._bump(admitted_requests=1, admitted_rows=t.rows)
            with self._m_lock:
                if depth > self._metrics["max_queue_rows_seen"]:
                    self._metrics["max_queue_rows_seen"] = depth
            self._q_event.set()
        else:
            self._bump(shed_requests=1, shed_rows=t.rows)
            t._resolve("shed")
        return t

    @property
    def queued_rows(self) -> int:
        return self._queued_rows

    def serve_once(self) -> int:
        """Drain one packed batch; returns rows served (0 = queue empty).

        Pops FIFO tickets until the pack would exceed ``max_batch_rows``
        (always at least one), pins the published record with ONE read,
        serves the concatenated rows through ``predict_snapshot`` and
        splits the predictions back per ticket.  Each row's prediction is
        independent of the packing, so every ticket equals a standalone
        ``predict_snapshot`` on its pinned version bit for bit."""
        with self._q_lock:
            if not self._queue:
                self._q_event.clear()
                return 0
            batch, rows = [], 0
            while self._queue and (not batch or
                    rows + self._queue[0].rows <= self.cfg.max_batch_rows):
                t = self._queue.pop(0)
                batch.append(t)
                rows += t.rows
            self._queued_rows -= rows
        rec = self._published                   # the one pinned read
        X = batch[0].X if len(batch) == 1 else \
            np.concatenate([t.X for t in batch], axis=0)
        y = sv.predict_snapshot(rec.snap, X, device=self._dev).cpu().numpy()
        off = 0
        for t in batch:
            t._resolve("done", y[off:off + t.rows], rec.version)
            off += t.rows
        self._bump(served_requests=len(batch), served_rows=rows,
                   serve_batches=1)
        return rows

    # -- threaded mode -----------------------------------------------------

    def start(self):
        """Run the trainer and server loops on daemon threads; both loops
        are the single-step methods above in a while-loop."""
        if self._threads:
            raise RuntimeError("engine already started")
        self._stop.clear()

        def _server():
            while not self._stop.is_set():
                if self.serve_once() == 0:
                    self._q_event.wait(timeout=0.005)

        def _trainer():
            while not self._stop.is_set():
                if not self.train_once():
                    break
                time.sleep(0)                  # yield to the server

        self._threads = [
            threading.Thread(target=_server, name="engine-server",
                             daemon=True),
            threading.Thread(target=_trainer, name="engine-trainer",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the loops; ``drain=True`` first serves every queued ticket.
        Each join is bounded by ``timeout``; raises if a loop is still
        alive after it."""
        if drain:
            deadline = time.monotonic() + timeout
            while self._queued_rows and time.monotonic() < deadline:
                time.sleep(0.002)
        self._stop.set()
        self._q_event.set()
        for t in self._threads:
            t.join(timeout=timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        self._threads = []
        if alive:
            raise RuntimeError(f"engine threads still running: {alive}")
        while drain and self.serve_once():
            pass                                # whatever the race left
