"""Fault injection for the continuous-serving engine (the reference's
``core/faults.py``, DESIGN.md §5.6; numpy only, so the port keeps its own
copy).

Robustness you cannot inject, you cannot trust: the
:class:`repro_torch.core.engine.ServingEngine` threads a
:class:`FaultInjector` through every lifecycle boundary it owns and
calls :meth:`FaultInjector.fire` at each named **site**.  An unarmed
site is a no-op passthrough (zero cost on the hot path); an armed site
applies its fault — raise, sleep, drop, or corrupt-in-flight — for a
bounded number of firings and then disarms itself.  Tests and the
fault-injection harness arm exactly the failure they want to prove the
engine degrades gracefully under, and read back :attr:`FaultInjector.log`
to assert the fault actually fired.

Engine sites (the contract tests/test_torch_engine.py pins):

=================  ========================================================
``trainer.step``   before a training batch is absorbed — ``Kill`` here is
                   the trainer dying mid-sync-window
``publish``        the frozen snapshot in flight to the swap — ``Corrupt``
                   forges a torn model (the validation gate must reject
                   it and roll back), ``Drop`` loses the publish (the
                   staleness watchdog must notice), ``Delay`` stalls it
``ckpt.save``      before a checkpoint write — ``Kill`` is a trainer
                   preempted mid-save (the atomic-rename writer plus
                   validated restore must shrug it off)
=================  ========================================================

The module also provides :func:`bursty_arrivals`, the open-loop arrival
process the benchmarks and the admission-control tests drive the queue
with (a Poisson base rate punctuated by multiplied bursts — arrivals do
NOT wait for service, which is what makes overload reachable).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

__all__ = [
    "FaultError", "TrainerKilled", "DropSignal",
    "Kill", "Delay", "Drop", "Corrupt",
    "FaultInjector", "bursty_arrivals",
]


class FaultError(RuntimeError):
    """Base of every injected failure (so handlers can tell injected
    faults from organic bugs when they want to)."""


class TrainerKilled(FaultError):
    """The injected 'trainer process died here' exception."""


class DropSignal(FaultError):
    """Control-flow signal: the payload at this site is silently lost
    (a dropped publish, a lost message).  Sites that support dropping
    catch it and account the loss; it never escapes the engine."""


@dataclass
class Kill:
    """Raise ``exc_type`` at the site (default :class:`TrainerKilled`)."""
    exc_type: type = TrainerKilled
    message: str = "injected kill"

    def apply(self, site: str, payload):
        raise self.exc_type(f"{self.message} @ {site}")


@dataclass
class Delay:
    """Sleep ``seconds`` at the site, then pass the payload through."""
    seconds: float = 0.05

    def apply(self, site: str, payload):
        time.sleep(self.seconds)
        return payload


@dataclass
class Drop:
    """Raise :class:`DropSignal`: the site's payload is lost."""

    def apply(self, site: str, payload):
        raise DropSignal(f"injected drop @ {site}")


@dataclass
class Corrupt:
    """Transform the payload in flight: ``fn(payload) -> payload'``.

    The forged-value fault — e.g. NaN a snapshot threshold so the
    publish-validation gate must catch it.  ``fn`` must not mutate its
    argument (snapshots are frozen dataclasses; use
    ``dataclasses.replace`` around cloned tensors).
    """
    fn: Callable[[Any], Any]

    def apply(self, site: str, payload):
        return self.fn(payload)


@dataclass
class _Armed:
    fault: Any
    times: int          # remaining firings; disarms at 0
    after: int          # passthrough calls to skip before first firing


class FaultInjector:
    """Named-site fault hooks with bounded, self-disarming firings.

    ``arm(site, fault, times=1, after=0)`` queues ``fault`` at ``site``:
    the first ``after`` calls pass through untouched, the next ``times``
    calls apply the fault, then the site disarms.  Multiple arms on one
    site queue in FIFO order.  ``fire(site, payload=None)`` is what the
    engine calls — it returns the (possibly transformed) payload or
    raises the armed exception.  Thread-safe: the engine fires from its
    trainer and server threads concurrently.

    Every firing is appended to :attr:`log` as ``(site, fault)`` so
    tests can assert the fault actually happened (a fault test that
    passes because the fault never fired proves nothing).
    """

    def __init__(self):
        self._armed: Dict[str, List[_Armed]] = {}
        self._lock = threading.Lock()
        self.log: List[Tuple[str, Any]] = []

    def arm(self, site: str, fault, *, times: int = 1,
            after: int = 0) -> "FaultInjector":
        assert times >= 1 and after >= 0, (times, after)
        with self._lock:
            self._armed.setdefault(site, []).append(
                _Armed(fault, times, after))
        return self

    def armed(self, site: str) -> bool:
        with self._lock:
            return bool(self._armed.get(site))

    def fire(self, site: str, payload=None):
        with self._lock:
            queue = self._armed.get(site)
            if not queue:
                return payload
            head = queue[0]
            if head.after > 0:
                head.after -= 1
                return payload
            head.times -= 1
            if head.times == 0:
                queue.pop(0)
            self.log.append((site, head.fault))
        # apply OUTSIDE the lock: Delay must not serialize other sites
        return head.fault.apply(site, payload)

    def fired(self, site: str) -> int:
        """How many times any fault fired at ``site``."""
        return sum(1 for s, _ in self.log if s == site)


def bursty_arrivals(n_requests: int, *, base_rows: int = 64,
                    burst_factor: int = 10, burst_every: int = 8,
                    burst_len: int = 2, base_gap_s: float = 0.0,
                    jitter: float = 0.5, seed: int = 0):
    """Open-loop bursty arrival schedule: ``[(gap_s, rows), ...]``.

    A Poisson-ish base process (exponential gaps around ``base_gap_s``,
    request sizes around ``base_rows``) where every ``burst_every``-th
    arrival opens a burst of ``burst_len`` requests carrying
    ``burst_factor``× the rows at ~zero gap — the 10× spike the
    admission queue must shed, not absorb.  Deterministic per ``seed``
    (the schedule is data, not wall-clock: the caller sleeps the gaps,
    so the process stays open-loop even when service stalls).
    """
    rng = np.random.default_rng(seed)
    sched = []
    for i in range(n_requests):
        in_burst = burst_every > 0 and (i % burst_every) < burst_len \
            and i >= burst_every  # warm-up: first window stays calm
        rows = max(1, int(rng.normal(base_rows, jitter * base_rows * 0.2)))
        if in_burst:
            rows *= burst_factor
            gap = 0.0
        else:
            gap = float(rng.exponential(base_gap_s)) if base_gap_s else 0.0
        sched.append((gap, rows))
    return sched
